"""Filer update-event notification queues.

Behavioral match of weed/notification/configuration.go: a process-wide
`queue` that the filer's NotifyUpdateEvent pushes (key,
EventNotification) messages into (filer2/filer_notify.go:9-39).
The port of seaweedfs_tpu/notification/__init__.py, the core the filer
publishes to. Backends here: log (glog-style), memory (in-process,
subscribable), dirqueue (durable file-per-message directory),
logqueue (embedded partitioned segmented log with consumer groups, the
Kafka-role broker, notification/logqueue.py), kafka (real wire-protocol
producer, notification/kafka.py), and aws_sqs / google_pub_sub (the AWS
Query protocol with SigV4 and the Pub/Sub REST publish endpoint,
notification/cloud_queues.py). None need client libraries; the gates
are connectivity and credentials.
"""

from __future__ import annotations

import json
import os
import threading
import time
from collections import deque

from seaweedfs_tpu_torch.pb import filer_pb2 as fpb
from seaweedfs_tpu_torch.util import durable
from seaweedfs_tpu_torch.util import wlog

queue = None  # process-wide, set by configure() (notification.Queue role)


class NotificationQueue:
    def send_message(self, key: str, message: fpb.EventNotification) -> None:
        raise NotImplementedError


class LogQueue(NotificationQueue):
    """notification/log: prints events (debugging aid)."""

    def send_message(self, key: str, message: fpb.EventNotification) -> None:
        wlog.info(
            "notify %s: old=%s new=%s delete_chunks=%s",
            key,
            message.old_entry.name or None,
            message.new_entry.name or None,
            message.delete_chunks,
        )


class MemoryQueue(NotificationQueue):
    """In-process queue with blocking subscription (test + single-node
    replication without external brokers)."""

    def __init__(self, maxlen: int = 65536):
        self._messages: deque = deque(maxlen=maxlen)
        self._cond = threading.Condition()

    def send_message(self, key: str, message: fpb.EventNotification) -> None:
        with self._cond:
            self._messages.append((key, message))
            self._cond.notify_all()

    def receive(self, timeout: float | None = None):
        """Pop one (key, message); None on timeout."""
        with self._cond:
            if not self._messages:
                self._cond.wait(timeout)
            if not self._messages:
                return None
            return self._messages.popleft()

    def __len__(self) -> int:
        return len(self._messages)


class DirQueue(NotificationQueue):
    """Durable directory queue: one file per message, named by a
    monotonically increasing sequence so consumers replay in order.
    Fills the Kafka/SQS role for cross-process replication without
    external brokers."""

    def __init__(self, directory: str):
        self.dir = directory
        os.makedirs(directory, exist_ok=True)
        self._lock = threading.Lock()
        self._seq = self._max_existing_seq()

    def _max_existing_seq(self) -> int:
        best = 0
        for name in os.listdir(self.dir):
            if name.endswith(".msg"):
                try:
                    best = max(best, int(name.split(".")[0]))
                except ValueError:
                    pass
        return best

    def send_message(self, key: str, message: fpb.EventNotification) -> None:
        with self._lock:
            self._seq += 1
            seq = self._seq
        payload = json.dumps({"key": key, "ts": time.time()}).encode()
        blob = message.SerializeToString()
        tmp = os.path.join(self.dir, f".{seq:020d}.tmp")
        final = os.path.join(self.dir, f"{seq:020d}.msg")
        with open(tmp, "wb") as f:
            f.write(len(payload).to_bytes(4, "big") + payload + blob)
        # atomic + durable publish: consumers treat presence of the
        # .msg name as "event fired"; a crash must not un-fire it
        durable.publish(tmp, final)

    def consume(self, after_seq: int = 0):
        """Yield (seq, key, message) for every message with seq >
        after_seq, in order."""
        names = sorted(n for n in os.listdir(self.dir) if n.endswith(".msg"))
        for name in names:
            seq = int(name.split(".")[0])
            if seq <= after_seq:
                continue
            with open(os.path.join(self.dir, name), "rb") as f:
                hlen = int.from_bytes(f.read(4), "big")
                header = json.loads(f.read(hlen))
                msg = fpb.EventNotification()
                msg.ParseFromString(f.read())
            yield seq, header["key"], msg


# kafka / aws_sqs / google_pub_sub live in kafka.py and cloud_queues.py
# — real wire-protocol implementations, gated on connectivity or
# credentials rather than on client libraries.


def configure(cfg) -> NotificationQueue | None:
    """Build the process queue from a notification.toml Configuration
    (server/filer_server.go:28-32 LoadConfiguration)."""
    global queue
    if cfg.get_bool("notification.log.enabled"):
        queue = LogQueue()
    elif cfg.get_bool("notification.memory.enabled"):
        queue = MemoryQueue()
    elif cfg.get_bool("notification.dirqueue.enabled"):
        queue = DirQueue(cfg.get_string("notification.dirqueue.dir", "./notifications"))
    elif cfg.get_bool("notification.logqueue.enabled"):
        from seaweedfs_tpu_torch.notification.logqueue import PartitionedLogQueue

        queue = PartitionedLogQueue(
            cfg.get_string("notification.logqueue.dir", "./notifications"),
            partitions=cfg.get_int("notification.logqueue.partitions", 4),
        )
    elif cfg.get_bool("notification.kafka.enabled"):
        # real wire-protocol producer (notification/kafka.py); the gate
        # is connectivity, not a library — constructing raises with
        # guidance when no broker answers
        from seaweedfs_tpu_torch.notification.kafka import KafkaQueue

        queue = KafkaQueue(
            cfg.get_string("notification.kafka.hosts", "localhost:9092"),
            topic=cfg.get_string("notification.kafka.topic", "seaweedfs_filer"),
        )
    elif cfg.get_bool("notification.aws_sqs.enabled"):
        from seaweedfs_tpu_torch.notification.cloud_queues import SqsQueue

        queue = SqsQueue(
            cfg.get_string("notification.aws_sqs.aws_access_key_id", ""),
            cfg.get_string("notification.aws_sqs.aws_secret_access_key", ""),
            cfg.get_string("notification.aws_sqs.region", "us-east-1"),
            cfg.get_string("notification.aws_sqs.sqs_queue_name", ""),
            endpoint=cfg.get_string("notification.aws_sqs.endpoint", ""),
        )
    elif cfg.get_bool("notification.google_pub_sub.enabled"):
        from seaweedfs_tpu_torch.notification.cloud_queues import PubSubQueue

        queue = PubSubQueue(
            cfg.get_string("notification.google_pub_sub.project_id", ""),
            cfg.get_string("notification.google_pub_sub.topic", "seaweedfs_filer_topic"),
            token=cfg.get_string("notification.google_pub_sub.token", ""),
            token_file=cfg.get_string(
                "notification.google_pub_sub.token_file", ""
            ),
            endpoint=cfg.get_string(
                "notification.google_pub_sub.endpoint",
                "https://pubsub.googleapis.com",
            ),
        )
    else:
        queue = None
    return queue
