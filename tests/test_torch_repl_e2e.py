"""Cross-cluster replication in the port as a standing workload: the
counterpart of the reference's tests/test_repl_e2e.py over two port
clusters in this process. S3 writes on a source cluster flow through the
partitioned logqueue into a second live cluster that serves them byte
for byte; then a partition of the sink mid-replication (a bounded
failure, and after the heal convergence with no acknowledged write
lost), replication lag racing the vacuum, the lag gauge with its alert
and the `replication.lag` verb, and the WEED_REPL kill switch. The
partition is the reference's chaos proxy pair, a TCP proxy used here as
a test instrument. Every wait polls a condition under a deadline."""

import io
import urllib.error
import urllib.request

import pytest

from seaweedfs_tpu.analysis.chaos import ProxyPair
from seaweedfs_tpu_torch import notification
from seaweedfs_tpu_torch.notification.logqueue import PartitionedLogQueue
from seaweedfs_tpu_torch.replication.replicate_runner import (
    _consume_logqueue,
    repl_enabled,
    run_replicate,
)
from seaweedfs_tpu_torch.replication.replicator import Replicator
from seaweedfs_tpu_torch.replication.sink import FilerSink
from seaweedfs_tpu_torch.replication.source import FilerSource
from seaweedfs_tpu_torch.s3api import S3ApiServer
from seaweedfs_tpu_torch.shell.command_env import CommandEnv
from seaweedfs_tpu_torch.shell.commands import run_command
from seaweedfs_tpu_torch.util import deadline as _deadline
from seaweedfs_tpu_torch.util.availability import free_port

from tests.test_torch_replication import PortCluster, wait_for

GROUP = "replicate"


@pytest.fixture(scope="module")
def repl_world(tmp_path_factory):
    """A source port cluster (its master's collector on, its filer
    announcing, an open S3 gateway on it) whose filer publishes to the
    logqueue while a test arms it, a sink port cluster, and the queue."""
    lq = PartitionedLogQueue(str(tmp_path_factory.mktemp("replq")), partitions=4)
    clusters, s3 = [], None
    # the filer snapshots whether a notification queue exists when it is
    # built: arm it around the source only, so the sink cluster does not
    # echo applies back into the queue
    notification.queue = lq
    try:
        clusters.append(PortCluster(str(tmp_path_factory.mktemp("src")), telemetry=True))
        notification.queue = None
        clusters.append(PortCluster(str(tmp_path_factory.mktemp("dst"))))
        s3 = S3ApiServer(filer=clusters[0].filer_addr, port=free_port())
        s3.start()
        yield lq, clusters[0], clusters[1], s3
    finally:
        notification.queue = None
        if s3 is not None:
            s3.stop()
        for c in reversed(clusters):
            c.stop()
        lq.close()


class _armed:
    """Route the source filer's mutations into the logqueue meanwhile."""

    def __init__(self, lq):
        self.lq = lq

    def __enter__(self):
        notification.queue = self.lq

    def __exit__(self, *exc):
        notification.queue = None


def _req(url, method="GET", data=None, headers=None, timeout=15):
    r = urllib.request.Request(url, data=data, method=method)
    for k, v in (headers or {}).items():
        r.add_header(k, v)
    return urllib.request.urlopen(r, timeout=timeout)


def _replicator(src, dst_addr):
    return Replicator(FilerSource(src.filer_addr, directory="/buckets"),
                      FilerSink(dst_addr, directory="/backup"))


def _drain(lq, replicator, idle=0.5):
    return _consume_logqueue(lq, replicator, poll_interval=0.05, stop_after_idle=idle)


class TestS3WriteToRemoteCluster:
    def test_write_flows_and_remote_serves_byte_identical(self, repl_world):
        lq, src, dst, s3 = repl_world
        body = bytes((i * 37) & 0xFF for i in range(120_000))
        with _armed(lq):
            _req(f"http://127.0.0.1:{s3.port}/replbkt", "PUT").close()
            _req(f"http://127.0.0.1:{s3.port}/replbkt/pic.bin", "PUT", data=body).close()
        assert lq.depth(GROUP) >= 1
        assert _drain(lq, _replicator(src, dst.filer_addr)) == 0
        assert lq.depth(GROUP) == 0
        # the remote filer serves the object from its own volumes
        with _req(f"http://{dst.filer_addr}/backup/replbkt/pic.bin") as r:
            assert r.read() == body
        # and so does a remote S3 gateway over the mirror tree
        s3r = S3ApiServer(filer=dst.filer_addr, port=free_port(), buckets_path="/backup")
        s3r.start()
        try:
            with _req(f"http://127.0.0.1:{s3r.port}/replbkt/pic.bin") as r:
                assert r.read() == body
            with _req(f"http://127.0.0.1:{s3r.port}/replbkt/pic.bin",
                      headers={"Range": "bytes=100-299"}) as r:
                assert r.status == 206
                assert r.read() == body[100:300]
        finally:
            s3r.stop()

    def test_delete_propagates(self, repl_world):
        lq, src, dst, s3 = repl_world
        with _armed(lq):
            _req(f"http://127.0.0.1:{s3.port}/replbkt/gone.bin", "PUT",
                 data=b"to-be-deleted").close()
        assert _drain(lq, _replicator(src, dst.filer_addr)) == 0
        with _req(f"http://{dst.filer_addr}/backup/replbkt/gone.bin") as r:
            assert r.read() == b"to-be-deleted"
        with _armed(lq):
            _req(f"http://127.0.0.1:{s3.port}/replbkt/gone.bin", "DELETE").close()
        assert _drain(lq, _replicator(src, dst.filer_addr)) == 0
        with pytest.raises(urllib.error.HTTPError):
            _req(f"http://{dst.filer_addr}/backup/replbkt/gone.bin").close()

    def test_kill_switch_leaves_queue_intact(self, repl_world, monkeypatch):
        lq, src, dst, s3 = repl_world
        with _armed(lq):
            _req(f"http://127.0.0.1:{s3.port}/replbkt/later.bin", "PUT",
                 data=b"after-reenable").close()
        depth = lq.depth(GROUP)
        assert depth >= 1
        monkeypatch.setenv("WEED_REPL", "0")
        assert not repl_enabled()
        # the consumer refuses to run and consumes nothing, so re-enabling
        # resumes from the committed cursor
        assert run_replicate(stop_after_idle=0.2) == 0
        assert lq.depth(GROUP) == depth
        monkeypatch.delenv("WEED_REPL")
        assert _drain(lq, _replicator(src, dst.filer_addr)) == 0
        with _req(f"http://{dst.filer_addr}/backup/replbkt/later.bin") as r:
            assert r.read() == b"after-reenable"


class TestPartitionMidReplication:
    def test_partition_stalls_then_heals_without_loss(self, repl_world):
        lq, src, dst, s3 = repl_world
        pair = ProxyPair(dst.filer_addr)
        try:
            repl = _replicator(src, pair.addr)
            payloads = {f"part{i}.bin": f"partition-payload-{i} ".encode() * 500
                        for i in range(3)}
            with _armed(lq):
                for name, body in payloads.items():
                    _req(f"http://127.0.0.1:{s3.port}/replbkt/{name}", "PUT",
                         data=body).close()
            pair.partition()
            # the sink's gRPC calls take their timeout from the ambient
            # deadline: without it a blackholed connection would park the
            # drain for good
            with _deadline.scope(_deadline.Deadline.after(2.0)):
                rc = _consume_logqueue(lq, repl, poll_interval=0.2, stop_after_idle=0.6)
            assert rc == 1  # stuck on failures, not idle
            assert lq.depth(GROUP) > 0  # the lag shows, nothing is lost
            pair.heal()
            assert _drain(lq, repl, idle=1.0) == 0
            assert lq.depth(GROUP) == 0
            for name, body in payloads.items():
                with _req(f"http://{dst.filer_addr}/backup/replbkt/{name}") as r:
                    assert r.read() == body
        finally:
            pair.stop()


class TestLagVersusVacuum:
    def test_vacuum_during_lag_converges_without_acked_loss(self, repl_world):
        lq, src, dst, s3 = repl_world
        keep = b"survivor " * 3000
        with _armed(lq):
            _req(f"http://{src.filer_addr}/buckets/vac/keep.bin", "POST", data=keep).close()
            _req(f"http://{src.filer_addr}/buckets/vac/drop.bin", "POST",
                 data=b"doomed " * 3000).close()
            # the replica lags (nothing drained yet) when the source
            # deletes drop.bin and vacuums its chunks away
            _req(f"http://{src.filer_addr}/buckets/vac/drop.bin", "DELETE").close()
        out = io.StringIO()
        run_command(CommandEnv([src.maddr]), "volume.vacuum -garbageThreshold 0.0001", out)
        # keep.bin replicates whole; drop.bin's create cannot fetch its
        # vacuumed chunks and poisons out after the retry budget, then its
        # delete applies, and both clusters converge without it
        rc = _consume_logqueue(lq, _replicator(src, dst.filer_addr), poll_interval=0.05,
                               stop_after_idle=4.0)
        assert rc == 0
        assert lq.depth(GROUP) == 0
        with _req(f"http://{dst.filer_addr}/backup/vac/keep.bin") as r:
            assert r.read() == keep
        for filer, root in ((src.filer_addr, "/buckets"), (dst.filer_addr, "/backup")):
            with pytest.raises(urllib.error.HTTPError):
                _req(f"http://{filer}{root}/vac/drop.bin").close()


class TestLagAlertAndShell:
    def test_lag_gauge_alert_and_verb(self, repl_world):
        lq, src, dst, s3 = repl_world
        # armed for the whole test: the filer's /metrics pre-render hook
        # reads notification.queue's consumer-group depth when it renders,
        # and the leader's collector scrapes on its own schedule
        with _armed(lq):
            for i in range(4):
                _req(f"http://127.0.0.1:{s3.port}/replbkt/lag{i}.bin", "PUT",
                     data=b"backlog").close()
            assert lq.depth(GROUP) >= 3
            with _req(f"http://{src.filer_addr}/metrics") as r:
                metrics = r.read().decode()
            line = next(ln for ln in metrics.splitlines()
                        if ln.startswith("weed_replication_lag_events"))
            assert float(line.rsplit(" ", 1)[1]) >= 3, line

            def alert_fired():
                alerts = src.master.telemetry.alerts.payload()
                return any(a.get("Alert") == "replication_lag"
                           for a in alerts.get("Firing", []))

            assert wait_for(alert_fired, 30), src.master.telemetry.alerts.payload()
            env = CommandEnv([src.maddr])
            text = run_command(env, "replication.lag")
            assert "event(s) behind" in text, text
            assert "ALERT warning" in text, text
            # drained, the lag falls to zero and the alert clears
            assert _drain(lq, _replicator(src, dst.filer_addr)) == 0
            assert wait_for(lambda: not alert_fired(), 30)
            assert f"{src.filer_addr}: 0 event(s) behind" in run_command(env, "replication.lag")


def test_chip_smoke_replication_phase_on_the_cpu(tmp_path):
    """chip_smoke.py's phase 3m at 16 MiB of files and a 4 MiB big one on
    the host codec: the lag gauge equal to the queue's events, every file
    read back from the second cluster with a shard holder of the first
    lost, a directory delete carried over, the runner's restart from its
    cursor rewriting nothing, the filers and the runner free of libcuda
    and torch, every process ending with 0."""
    import sys

    from tests.test_torch_replication import REPO

    sys.path.insert(0, REPO)
    import chip_smoke

    runs = chip_smoke.run_replication_phase(str(tmp_path), 16 << 20, 0, device="cpu",
                                            card="cpu", big_bytes=4 << 20)
    repl = runs["replication"]
    assert repl["touched"] > 0 and repl["events"] >= repl["files"] - 1
    assert runs["repl_degraded"]["files"] == repl["files"] - 1
    assert set(repl["walls"]) >= {"a_up", "b_fill", "c_encode_balance", "e_drain", "f_read_b",
                                  "g_delete", "h_resume"}
