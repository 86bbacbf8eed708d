"""`weed filer.replicate` — consume the notification queue and drive a
Replicator (weed/command/filer_replicate.go runFilerReplicate).

The port of seaweedfs_tpu/replication/replicate_runner.py: the logqueue,
kafka and dirqueue arms into the filer, local, s3, gcs, azure and
backblaze sinks. Every loop also ends, after committing what it
applied, when `stop` is set: `filer.replicate` sets it on SIGTERM and
SIGINT, and a restart resumes from the cursor (the kafka arm's offset
files).
"""

from __future__ import annotations

import os
import threading
import time
import tomllib

from seaweedfs_tpu_torch.replication.replicator import Replicator
from seaweedfs_tpu_torch.replication.sink import FilerSink, LocalSink, S3Sink
from seaweedfs_tpu_torch.replication.source import FilerSource
from seaweedfs_tpu_torch.scrub.arbiter import get_arbiter
from seaweedfs_tpu_torch.stats.metrics import REPLICATION_APPLIED, REPLICATION_LAG
from seaweedfs_tpu_torch.util import durable
from seaweedfs_tpu_torch.util import wlog
from seaweedfs_tpu_torch.util.config import load_config, Configuration


def repl_enabled() -> bool:
    """`WEED_REPL=0` kills the replication consumer wholesale: the
    runner exits without draining. The durable queue keeps absorbing
    filer events, so flipping the switch back on resumes from the
    committed cursor — lag, not loss."""
    return os.environ.get("WEED_REPL", "1") != "0"


def build_replicator(repl_cfg: Configuration) -> Replicator:
    src = repl_cfg.sub("source.filer")
    source = FilerSource(
        src.get("grpcAddress", "localhost:8888"),
        directory=src.get("directory", "/buckets"),
    )
    if repl_cfg.get_bool("sink.filer.enabled"):
        s = repl_cfg.sub("sink.filer")
        sink = FilerSink(
            s.get("grpcAddress", "localhost:8888"),
            directory=s.get("directory", "/backup"),
            replication=s.get("replication", ""),
            collection=s.get("collection", ""),
            ttl_sec=int(s.get("ttlSec", 0)),
        )
    elif repl_cfg.get_bool("sink.local.enabled"):
        sink = LocalSink(repl_cfg.sub("sink.local").get("directory", "/tmp/backup"))
    elif repl_cfg.get_bool("sink.s3.enabled"):
        s = repl_cfg.sub("sink.s3")
        sink = S3Sink(
            s.get("endpoint", "localhost:8333"),
            s.get("bucket", "backup"),
            access_key=s.get("aws_access_key_id", ""),
            secret_key=s.get("aws_secret_access_key", ""),
            directory=s.get("directory", ""),
            region=s.get("region", "us-east-1"),
        )
    elif repl_cfg.get_bool("sink.gcs.enabled"):
        from seaweedfs_tpu_torch.replication.cloud_sinks import GcsSink

        s = repl_cfg.sub("sink.gcs")
        endpoint = s.get("endpoint", "https://storage.googleapis.com")
        if not s.get("token", "") and "googleapis.com" in endpoint:
            # real GCS always needs a bearer token; only custom
            # endpoints (emulators, the test fake) may go tokenless
            raise RuntimeError(
                "sink.gcs needs an OAuth bearer `token` (see "
                "replication/cloud_sinks.py), or a custom `endpoint`"
            )
        sink = GcsSink(
            s.get("bucket", ""),
            token=s.get("token", ""),
            directory=s.get("directory", ""),
            endpoint=endpoint,
        )
    elif repl_cfg.get_bool("sink.azure.enabled"):
        from seaweedfs_tpu_torch.replication.cloud_sinks import AzureSink

        s = repl_cfg.sub("sink.azure")
        if not s.get("account_key", ""):
            raise RuntimeError(
                "sink.azure needs account_name/account_key (the SharedKey "
                "credentials); see replication/cloud_sinks.py"
            )
        sink = AzureSink(
            s.get("account_name", ""),
            s.get("account_key", ""),
            s.get("container", ""),
            directory=s.get("directory", ""),
            endpoint=s.get("endpoint", ""),
        )
    elif repl_cfg.get_bool("sink.backblaze.enabled"):
        from seaweedfs_tpu_torch.replication.cloud_sinks import B2Sink

        s = repl_cfg.sub("sink.backblaze")
        if not s.get("b2_master_application_key", ""):
            raise RuntimeError(
                "sink.backblaze needs b2_account_id/"
                "b2_master_application_key; see replication/cloud_sinks.py"
            )
        sink = B2Sink(
            s.get("b2_account_id", ""),
            s.get("b2_master_application_key", ""),
            s.get("bucket", ""),
            directory=s.get("directory", ""),
            endpoint=s.get("endpoint", "https://api.backblazeb2.com"),
        )
    else:
        raise RuntimeError("no enabled sink in replication.toml")
    return Replicator(source, sink)


def run_replicate(
    config_path: str = "",
    poll_interval: float = 1.0,
    stop_after_idle: float = 0.0,
    stop: threading.Event | None = None,
) -> int:
    """Consume the configured durable queue (dirqueue, or the
    partitioned logqueue with consumer group "replicate") and replicate
    each event; offsets are checkpointed so restarts resume.
    stop_after_idle > 0 makes the loop exit after that many idle
    seconds (tests / one-shot drains); `stop` ends it with exit code 0."""
    stop = stop or threading.Event()
    if not repl_enabled():
        # kill switch (docs/TIERING.md): events keep accumulating in
        # the durable queue; re-enabling resumes from the committed
        # cursor with nothing lost
        wlog.warning("filer.replicate disabled (WEED_REPL=0); exiting")
        return 0
    if config_path:
        with open(config_path, "rb") as f:
            repl_cfg = Configuration(tomllib.load(f))
    else:
        repl_cfg = load_config("replication", required=True)
    notif_cfg = load_config("notification", required=False)

    from seaweedfs_tpu_torch import notification

    replicator = build_replicator(repl_cfg)
    if notif_cfg.get_bool("notification.logqueue.enabled"):
        from seaweedfs_tpu_torch.notification.logqueue import PartitionedLogQueue

        qdir = notif_cfg.get_string("notification.logqueue.dir", "./notifications")
        lq = PartitionedLogQueue(
            qdir,
            partitions=notif_cfg.get_int("notification.logqueue.partitions", 4),
        )
        wlog.info(
            "filer.replicate consuming logqueue %s (lag %d)",
            qdir,
            lq.depth("replicate"),
        )
        try:
            return _consume_logqueue(
                lq, replicator, poll_interval, stop_after_idle, stop
            )
        finally:
            lq.close()
    if notif_cfg.get_bool("notification.kafka.enabled"):
        from seaweedfs_tpu_torch.notification.kafka import KafkaSubscriber

        hosts = notif_cfg.get_string("notification.kafka.hosts", "localhost:9092")
        sub = KafkaSubscriber(
            hosts,
            topic=notif_cfg.get_string(
                "notification.kafka.topic", "seaweedfs_filer"
            ),
        )
        adapter = _KafkaOffsetAdapter(
            sub,
            notif_cfg.get_string(
                "notification.kafka.offset_dir", "./kafka_offsets"
            ),
        )
        wlog.info("filer.replicate consuming kafka %s", hosts)
        try:
            return _consume_logqueue(
                adapter, replicator, poll_interval, stop_after_idle, stop
            )
        finally:
            sub.close()
    qdir = notif_cfg.get_string("notification.dirqueue.dir", "./notifications")
    dirqueue = notification.DirQueue(qdir)
    offset_file = os.path.join(qdir, ".replicate_offset")
    after = 0
    if os.path.exists(offset_file):
        with open(offset_file) as f:
            after = int(f.read().strip() or "0")
    idle_since = time.time()
    wlog.info("filer.replicate consuming %s from seq %d", qdir, after)
    while True:
        progressed = False
        for seq, key, msg in dirqueue.consume(after_seq=after):
            if stop.is_set():
                return 0
            try:
                replicator.replicate(key, msg)
            except Exception as e:  # noqa: BLE001 — keep consuming
                wlog.error("replicate %s: %s", key, e)
            after = seq
            with open(offset_file, "w") as f:
                f.write(str(after))
            progressed = True
        if progressed:
            idle_since = time.time()
        elif stop_after_idle and time.time() - idle_since > stop_after_idle:
            return 0
        elif stop.wait(poll_interval):
            return 0


class _KafkaOffsetAdapter:
    """Present a KafkaSubscriber through the logqueue consumer surface
    (poll/commit/trim) so the at-least-once drain loop below serves
    both. Offsets are durable on the consumer side (one file per
    partition, atomic replace) — the reference's sarama consumer keeps
    them broker-side via group coordination, which kafka.py
    deliberately omits (single subscriber per topic; see its module
    docstring)."""

    def __init__(self, sub, offset_dir: str):
        self._sub = sub
        self._dir = offset_dir
        os.makedirs(offset_dir, exist_ok=True)
        for p in sub.partitions:
            try:
                with open(os.path.join(offset_dir, f"p{p:03d}")) as f:
                    sub.offsets[p] = int(f.read().strip() or "0")
            except (OSError, ValueError):
                pass

    def poll(self, group: str, max_records: int = 256):
        return self._sub.poll(max_records)

    def commit(self, group: str, partition: int, next_offset: int) -> None:
        self._sub.commit(partition, next_offset)
        path = os.path.join(self._dir, f"p{partition:03d}")
        tmp = path + ".tmp"
        with open(tmp, "w") as f:
            f.write(str(next_offset))
        # same contract as logqueue.commit: lost = re-replicate (safe,
        # idempotent PUTs), torn = parse failure on restart
        durable.publish(tmp, path)

    def trim(self) -> int:
        return 0  # retention is the broker's concern


_MAX_EVENT_RETRIES = 8


def _consume_logqueue(lq, replicator, poll_interval, stop_after_idle, stop=None) -> int:
    """Drain loop over the partitioned log: poll → replicate →
    commit-per-partition, then trim consumed segments.

    At-least-once for real: a failed event does NOT advance its
    partition's committed offset — the next poll() re-delivers from the
    last success, preserving per-partition order behind the failure.
    After _MAX_EVENT_RETRIES redeliveries the event is declared poison
    and skipped (committed past) so one bad event can't wedge its
    partition forever. When `stop` fires, the events applied so far are
    committed and the loop returns 0."""
    stop = stop or threading.Event()
    group = "replicate"
    idle_since = time.time()
    retries: dict[tuple[int, int], int] = {}  # (partition, offset) → attempts

    def _sample_lag() -> None:
        # lag = events the producer wrote that this consumer hasn't
        # committed past; surfaced on /metrics for the telemetry
        # collector's RULE_REPL_LAG alert (the Kafka adapter has no
        # cheap depth — it just doesn't report)
        depth = getattr(lq, "depth", None)
        if callable(depth):
            try:
                REPLICATION_LAG.set(depth(group), group)
            except OSError:
                pass

    while True:
        if stop.is_set():
            return 0
        batch = lq.poll(group)
        _sample_lag()
        if batch:
            high: dict[int, int] = {}
            stalled: set[int] = set()
            for part, offset, key, msg in batch:
                if part in stalled:
                    continue  # order: nothing commits past the failure
                # cross-cluster apply traffic pays the bandwidth
                # arbiter: max-min share against rebuild/handoff/tier,
                # yielding to foreground serving (docs/TIERING.md)
                if not get_arbiter().take(
                    "replication", max(msg.ByteSize(), 1), stop=stop
                ):
                    break  # stopped while waiting for its share
                try:
                    replicator.replicate(key, msg)
                except Exception as e:  # noqa: BLE001 — redeliver next poll
                    attempts = retries.get((part, offset), 0) + 1
                    if attempts >= _MAX_EVENT_RETRIES:
                        wlog.error(
                            "replicate %s: %s — poison after %d attempts, skipping",
                            key, e, attempts,
                        )
                        retries.pop((part, offset), None)
                        high[part] = offset + 1  # give up: commit past it
                        REPLICATION_APPLIED.labels("skipped").inc()
                    else:
                        wlog.error(
                            "replicate %s: %s (attempt %d; partition %d "
                            "redelivers from offset %d)",
                            key, e, attempts, part, offset,
                        )
                        retries[(part, offset)] = attempts
                        stalled.add(part)
                        REPLICATION_APPLIED.labels("error").inc()
                    continue
                retries.pop((part, offset), None)
                high[part] = offset + 1
                REPLICATION_APPLIED.labels("ok").inc()
                if stop.is_set():
                    break
            for part, next_off in high.items():
                lq.commit(group, part, next_off)
            lq.trim()
            _sample_lag()
            if high:
                idle_since = time.time()
            if stalled:
                if stop_after_idle and time.time() - idle_since > stop_after_idle:
                    return 1  # stuck on failures, not idle: nonzero
                if stop.wait(poll_interval):  # backoff before redelivery
                    return 0
        elif stop_after_idle and time.time() - idle_since > stop_after_idle:
            return 0
        elif stop.wait(poll_interval):
            return 0
