"""In-repo fake Kafka broker: the offline test peer for kafka.py.

Implements exactly the protocol surface the client speaks — Metadata
v0, Produce v3, Fetch v4 with record-batch v2 — over a threaded TCP
server, storing records per (topic, partition) in memory. Base offsets
are assigned on append like a real log; Fetch returns re-encoded
batches from the requested offset. The point is an end-to-end wire
test (replication e2e over a real socket) without a JVM in the image;
it is NOT a broker (no groups, no replication, no retention).

Runnable standalone for manual poking:
    python -m seaweedfs_tpu_torch.notification.kafka_fake [port [partitions]]

The port of seaweedfs_tpu/notification/kafka_fake.py. The command takes
the partition count as a second argument, and SIGTERM ends it with exit
code 0, as it does the port's daemons.
"""

from __future__ import annotations

import socket
import socketserver
import struct
import threading

from seaweedfs_tpu_torch.notification.kafka import (
    API_FETCH,
    API_METADATA,
    API_PRODUCE,
    _Reader,
    _bytes,
    _str,
    decode_record_batches,
    encode_record_batch,
)


class FakeKafkaBroker:
    def __init__(self, host: str = "127.0.0.1", port: int = 0, partitions: int = 2):
        self.partitions = partitions
        # ApiVersions ranges advertised to clients; tests shrink these
        # to exercise the client's unsupported-version gate
        self.api_ranges = {0: (0, 8), 1: (0, 11), 3: (0, 9), 18: (0, 0)}
        # drop connections on the ApiVersions probe like a pre-0.10
        # broker (tests of the client's optimistic fallback)
        self.drop_api_versions = False
        # (topic, partition) -> list[(key, value)]; index == offset
        self.logs: dict[tuple[str, int], list] = {}
        self._lock = threading.Lock()
        broker = self

        class Handler(socketserver.BaseRequestHandler):
            def handle(self):
                self.request.setsockopt(
                    socket.IPPROTO_TCP, socket.TCP_NODELAY, True
                )
                rfile = self.request.makefile("rb")
                while True:
                    raw = rfile.read(4)
                    if len(raw) < 4:
                        return
                    (size,) = struct.unpack(">i", raw)
                    payload = rfile.read(size)
                    if len(payload) < size:
                        return
                    r = _Reader(payload)
                    api_key, api_version, corr = r.i16(), r.i16(), r.i32()
                    r.string()  # client id
                    if api_key == 18:  # ApiVersions
                        if broker.drop_api_versions:
                            return  # pre-0.10 behavior: kill the conn
                        body = struct.pack(">hi", 0, len(broker.api_ranges))
                        for k, (lo, hi) in sorted(broker.api_ranges.items()):
                            body += struct.pack(">hhh", k, lo, hi)
                    elif api_key == API_METADATA:
                        body = broker._metadata(r)
                    elif api_key == API_PRODUCE:
                        body = broker._produce(r)
                    elif api_key == API_FETCH:
                        body = broker._fetch(r)
                    else:
                        return  # unsupported: drop the connection
                    resp = struct.pack(">i", corr) + body
                    self.request.sendall(struct.pack(">i", len(resp)) + resp)

        self._server = socketserver.ThreadingTCPServer((host, port), Handler)
        self._server.daemon_threads = True
        self.host, self.port = self._server.server_address

    # --- api bodies -----------------------------------------------------
    def _metadata(self, r: _Reader) -> bytes:
        topics = [r.string() for _ in range(r.i32())]
        out = struct.pack(">i", 1)  # one broker
        out += struct.pack(">i", 0) + _str(self.host) + struct.pack(">i", self.port)
        out += struct.pack(">i", len(topics))
        for t in topics:
            out += struct.pack(">h", 0) + _str(t)
            out += struct.pack(">i", self.partitions)
            for p in range(self.partitions):
                out += struct.pack(">hiii", 0, p, 0, 1)  # err, id, leader, nreplicas
                out += struct.pack(">i", 0)  # replica 0
                out += struct.pack(">ii", 1, 0)  # isr [0]
        return out

    def _produce(self, r: _Reader) -> bytes:
        r.string()  # transactional id
        r.i16()  # acks
        r.i32()  # timeout
        out_topics = []
        for _ in range(r.i32()):
            topic = r.string()
            parts = []
            for _p in range(r.i32()):
                pid = r.i32()
                blob = r.nbytes() or b""
                records = decode_record_batches(blob)
                with self._lock:
                    log = self.logs.setdefault((topic, pid), [])
                    base = len(log)
                    log.extend((k, v) for _off, k, v in records)
                parts.append((pid, 0, base))
            out_topics.append((topic, parts))
        out = struct.pack(">i", len(out_topics))
        for topic, parts in out_topics:
            out += _str(topic) + struct.pack(">i", len(parts))
            for pid, err, base in parts:
                out += struct.pack(">ihqq", pid, err, base, -1)
        out += struct.pack(">i", 0)  # throttle
        return out

    def _fetch(self, r: _Reader) -> bytes:
        r.i32(), r.i32(), r.i32(), r.i32()  # replica, max_wait, min, max
        r.i8()  # isolation
        reqs = []
        for _ in range(r.i32()):
            topic = r.string()
            for _p in range(r.i32()):
                pid = r.i32()
                off = r.i64()
                r.i32()  # partition max bytes
                reqs.append((topic, pid, off))
        out = struct.pack(">i", 0)  # throttle
        by_topic: dict[str, list] = {}
        for topic, pid, off in reqs:
            by_topic.setdefault(topic, []).append((pid, off))
        out += struct.pack(">i", len(by_topic))
        for topic, parts in by_topic.items():
            out += _str(topic) + struct.pack(">i", len(parts))
            for pid, off in parts:
                with self._lock:
                    log = list(self.logs.get((topic, pid), []))
                high = len(log)
                slice_ = log[off:]
                if slice_:
                    blob = bytearray(
                        encode_record_batch([(k, v) for k, v in slice_], 0)
                    )
                    struct.pack_into(">q", blob, 0, off)  # base offset
                    blob = bytes(blob)
                else:
                    blob = b""
                out += struct.pack(">ihqq", pid, 0, high, high)
                out += struct.pack(">i", 0)  # no aborted txns
                out += _bytes(blob)
        return out

    # --- lifecycle ------------------------------------------------------
    def start(self) -> None:
        threading.Thread(
            target=self._server.serve_forever, daemon=True
        ).start()

    def stop(self) -> None:
        self._server.shutdown()
        self._server.server_close()


def main(argv: list[str]) -> int:
    """Serve on `port` (default 9092) with `partitions` per topic
    (default 2) until SIGINT or SIGTERM, then exit 0."""
    import signal

    port = int(argv[0]) if argv else 9092
    partitions = int(argv[1]) if len(argv) > 1 else 2
    b = FakeKafkaBroker(port=port, partitions=partitions)
    b.start()
    stop = threading.Event()
    for sig in (signal.SIGINT, signal.SIGTERM):
        signal.signal(sig, lambda *_: stop.set())
    print(f"fake kafka broker on {b.host}:{b.port}, {partitions} partitions a topic "
          "(ctrl-c to stop)", flush=True)
    while not stop.wait(0.5):
        pass
    b.stop()
    return 0


if __name__ == "__main__":
    import sys

    sys.exit(main(sys.argv[1:]))
