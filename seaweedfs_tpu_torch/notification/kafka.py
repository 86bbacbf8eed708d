"""Kafka wire-protocol client: the notification/kafka role, no library.

Behavioral match of weed/notification/kafka/kafka_queue.go (producer:
filer events → topic, partitioned by the entry path as the message
key) and weed/replication/sub/notification_kafka.go (consumer feeding
`weed filer.replicate`). The reference rides the sarama library; this
module speaks the broker protocol directly over one TCP connection —
the pieces the role needs, at pinned versions implemented end-to-end
(and mirrored by the in-repo fake broker, kafka_fake.py, so the whole
path is testable offline):

  ApiVersions — not sent; versions are pinned (below)
  Metadata v0 (api_key 3) — topic → partition leaders
  Produce  v3 (api_key 0) — record-batch v2 (magic 2) with crc32c,
               acks=1, one batch per send
  Fetch    v4 (api_key 1) — record-batch v2 decode from an offset

Consumer-group coordination (JoinGroup/OffsetCommit…) is deliberately
absent: the replicate runner owns its offsets durably on its side the
same way the embedded logqueue consumer does, so a single subscriber
per topic needs no broker-side group state. Connectivity is the gate:
constructing KafkaQueue dials the broker and raises with guidance when
nothing is listening (notification/__init__.py configure()).

Wire primitives are big-endian; record-batch internals use zigzag
varints (the v2 format).

The port of seaweedfs_tpu/notification/kafka.py. The batch CRC is the
port's host CRC-32C (util/crc.py); nothing here touches the card.
"""

from __future__ import annotations

import socket
import struct
import threading
import time

from seaweedfs_tpu_torch.pb import filer_pb2 as fpb

API_PRODUCE, API_FETCH, API_METADATA, API_VERSIONS = 0, 1, 3, 18
# the pinned wire versions this client speaks (module docstring)
PINNED_VERSIONS = {API_PRODUCE: 3, API_FETCH: 4, API_METADATA: 0}
_CLIENT_ID = "seaweedfs-tpu"


# --- primitive codecs -------------------------------------------------------


def _str(s: str | None) -> bytes:
    if s is None:
        return struct.pack(">h", -1)
    b = s.encode()
    return struct.pack(">h", len(b)) + b


def _bytes(b: bytes | None) -> bytes:
    if b is None:
        return struct.pack(">i", -1)
    return struct.pack(">i", len(b)) + b


def _zigzag(n: int) -> int:
    return (n << 1) ^ (n >> 63)


def _unzigzag(n: int) -> int:
    return (n >> 1) ^ -(n & 1)


def _varint(n: int) -> bytes:
    u = _zigzag(n) & 0xFFFFFFFFFFFFFFFF
    out = bytearray()
    while True:
        b = u & 0x7F
        u >>= 7
        if u:
            out.append(b | 0x80)
        else:
            out.append(b)
            return bytes(out)


class _Reader:
    def __init__(self, data: bytes):
        self.data = data
        self.off = 0

    def take(self, n: int) -> bytes:
        d = self.data[self.off : self.off + n]
        if len(d) < n:
            raise ValueError("kafka: short buffer")
        self.off += n
        return d

    def i8(self) -> int:
        return struct.unpack(">b", self.take(1))[0]

    def i16(self) -> int:
        return struct.unpack(">h", self.take(2))[0]

    def i32(self) -> int:
        return struct.unpack(">i", self.take(4))[0]

    def i64(self) -> int:
        return struct.unpack(">q", self.take(8))[0]

    def u32(self) -> int:
        return struct.unpack(">I", self.take(4))[0]

    def string(self) -> str | None:
        n = self.i16()
        return None if n < 0 else self.take(n).decode()

    def nbytes(self) -> bytes | None:
        n = self.i32()
        return None if n < 0 else self.take(n)

    def varint(self) -> int:
        shift = u = 0
        while True:
            b = self.data[self.off]
            self.off += 1
            u |= (b & 0x7F) << shift
            if not b & 0x80:
                return _unzigzag(u)
            shift += 7


# --- record batch v2 (magic 2) ----------------------------------------------


def _crc32c(data: bytes) -> int:
    from seaweedfs_tpu_torch.util.crc import crc32c

    return crc32c(data)


def encode_record_batch(
    records: list[tuple[bytes | None, bytes]], timestamp_ms: int
) -> bytes:
    """[(key, value)] → one record-batch v2 blob (base offset 0; the
    broker rewrites it on append)."""
    body = bytearray()
    for i, (key, value) in enumerate(records):
        rec = bytearray(b"\x00")  # attributes
        rec += _varint(0)  # timestamp delta
        rec += _varint(i)  # offset delta
        if key is None:
            rec += _varint(-1)
        else:
            rec += _varint(len(key)) + key
        rec += _varint(len(value)) + value
        rec += _varint(0)  # headers
        body += _varint(len(rec)) + rec
    n = len(records)
    head = struct.pack(
        ">hiqqqhii",
        0,  # attributes (no compression, create-time)
        n - 1,  # last offset delta
        timestamp_ms,  # first timestamp
        timestamp_ms,  # max timestamp
        -1,  # producer id
        -1,  # producer epoch
        -1,  # base sequence
        n,  # record count
    )
    crc_payload = head + bytes(body)
    crc = _crc32c(crc_payload)
    after_length = struct.pack(">iB I", 0, 2, crc) + crc_payload
    #                 partitionLeaderEpoch^ magic^  ^crc
    return struct.pack(">qi", 0, len(after_length)) + after_length


def decode_record_batches(blob: bytes):
    """record-set bytes → [(offset, key, value)] across all batches."""
    out = []
    r = _Reader(blob)
    while r.off + 61 <= len(r.data):
        base_offset = r.i64()
        batch_len = r.i32()
        end = r.off + batch_len
        if end > len(r.data):
            break  # partial batch at the tail (Fetch may truncate)
        r.i32()  # partition leader epoch
        magic = r.i8()
        if magic != 2:
            raise ValueError(f"kafka: unsupported magic {magic}")
        r.u32()  # crc (trusted: in-process / tested path)
        attrs = r.i16()
        if attrs & 0x07:
            # a real broker with compression.type set re-compresses on
            # append; walking the varint parser over a gzip/zstd blob
            # would die opaquely (or misparse) — fail diagnosably
            raise ValueError(
                "kafka: compressed record batches unsupported "
                f"(attributes={attrs:#x}); set compression.type=none "
                "on the topic"
            )
        r.i32()  # last offset delta
        r.i64()  # first timestamp
        r.i64()  # max timestamp
        r.i64()  # producer id
        r.i16()  # producer epoch
        r.i32()  # base sequence
        count = r.i32()
        for _ in range(count):
            r.varint()  # record length
            r.i8()  # attributes
            r.varint()  # timestamp delta
            delta = r.varint()
            klen = r.varint()
            key = None if klen < 0 else r.take(klen)
            vlen = r.varint()
            value = b"" if vlen < 0 else r.take(vlen)
            hdrs = r.varint()
            for _h in range(hdrs):
                hk = r.varint()
                r.take(hk)
                hv = r.varint()
                if hv > 0:
                    r.take(hv)
            out.append((base_offset + delta, key, value))
        r.off = end
    return out


# --- connection -------------------------------------------------------------


class KafkaConnection:
    """One broker connection: framed request/response, correlation ids."""

    def __init__(self, host: str, port: int, timeout: float = 10.0):
        self.sock = socket.create_connection((host, port), timeout=timeout)
        self.sock.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, True)
        self._rfile = self.sock.makefile("rb")
        self._corr = 0
        self._lock = threading.Lock()

    def close(self) -> None:
        for c in (self._rfile.close, self.sock.close):
            try:
                c()
            except OSError:
                pass

    def call(self, api_key: int, api_version: int, body: bytes) -> _Reader:
        with self._lock:
            self._corr += 1
            corr = self._corr
            req = (
                struct.pack(">hhi", api_key, api_version, corr)
                + _str(_CLIENT_ID)
                + body
            )
            self.sock.sendall(struct.pack(">i", len(req)) + req)
            raw = self._rfile.read(4)
            if len(raw) < 4:
                raise ConnectionError("kafka: broker closed connection")
            (size,) = struct.unpack(">i", raw)
            payload = self._rfile.read(size)
            if len(payload) < size:
                raise ConnectionError("kafka: short response")
        r = _Reader(payload)
        got = r.i32()
        if got != corr:
            raise ValueError(f"kafka: correlation mismatch {got} != {corr}")
        return r


class KafkaError(RuntimeError):
    """A broker-reported error code."""

    OFFSET_OUT_OF_RANGE = 1

    def __init__(self, api: str, code: int, high_watermark: int = -1):
        super().__init__(f"kafka {api} error {code}")
        self.code = code
        self.high_watermark = high_watermark


class KafkaClient:
    """Metadata + Produce + Fetch against one bootstrap broker."""

    def __init__(self, hosts: str, timeout: float = 10.0):
        host, _, port = hosts.split(",")[0].strip().partition(":")
        self.host, self.port = host, int(port or 9092)
        self.timeout = timeout
        self._conn: KafkaConnection | None = None
        self._versions_checked = False

    def _connection(self) -> KafkaConnection:
        if self._conn is None:
            conn = KafkaConnection(self.host, self.port, self.timeout)
            if not self._versions_checked:
                conn = self._negotiate(conn)
                self._versions_checked = True
            self._conn = conn
        return self._conn

    def _negotiate(self, conn: KafkaConnection) -> KafkaConnection:
        """ApiVersions handshake at dial (sarama negotiates the same
        way behind the reference's kafka queue): confirm the broker
        supports the pinned Metadata/Produce/Fetch versions, raising
        with guidance when it does not — a graceful gate instead of a
        mid-publish protocol error against a too-new/too-old broker.
        Brokers that kill the connection on the probe (pre-0.10, or
        proxies dropping unknown api keys) get the pinned versions
        optimistically on a fresh dial."""
        try:
            r = conn.call(API_VERSIONS, 0, b"")
            if r.i16() != 0:  # e.g. 35 UNSUPPORTED_VERSION — proceed
                return conn
            ranges = {}
            for _ in range(r.i32()):
                key, lo, hi = r.i16(), r.i16(), r.i16()
                ranges[key] = (lo, hi)
        except (OSError, ValueError, ConnectionError, struct.error, IndexError):
            # no/odd ApiVersions support (pre-0.10 broker, proxy with
            # strange framing): optimistic pinned versions, fresh dial
            conn.close()
            return KafkaConnection(self.host, self.port, self.timeout)
        names = {API_PRODUCE: "Produce", API_FETCH: "Fetch", API_METADATA: "Metadata"}
        for key, pinned in PINNED_VERSIONS.items():
            lo, hi = ranges.get(key, (None, None))
            if lo is None or not lo <= pinned <= hi:
                conn.close()
                raise RuntimeError(
                    f"kafka broker {self.host}:{self.port} does not support "
                    f"{names[key]} v{pinned} (broker offers "
                    f"{'nothing' if lo is None else f'v{lo}..v{hi}'}); this "
                    "client speaks pinned versions (Metadata v0 / Produce "
                    "v3 / Fetch v4, notification/kafka.py) — use a broker "
                    "in that range or bridge through one"
                )
        return conn

    def _call(self, api_key: int, api_version: int, body: bytes) -> _Reader:
        """call() with reconnect: a dead or desynced connection (broker
        restart, timeout mid-read leaving stale bytes, correlation
        mismatch) is dropped and the request retried once on a fresh
        dial — never cached forever."""
        for attempt in (0, 1):
            try:
                return self._connection().call(api_key, api_version, body)
            except (OSError, ValueError):
                self.close()
                if attempt:
                    raise
        raise AssertionError("unreachable")

    def close(self) -> None:
        if self._conn is not None:
            self._conn.close()
            self._conn = None

    def metadata(self, topic: str) -> list[int]:
        """Partition ids of `topic` (Metadata v0)."""
        body = struct.pack(">i", 1) + _str(topic)
        r = self._call(API_METADATA, 0, body)
        for _ in range(r.i32()):  # brokers
            r.i32(), r.string(), r.i32()
        partitions: list[int] = []
        for _ in range(r.i32()):  # topics
            err = r.i16()
            name = r.string()
            for _p in range(r.i32()):
                perr = r.i16()
                pid = r.i32()
                r.i32()  # leader
                for _x in range(r.i32()):
                    r.i32()  # replicas
                for _x in range(r.i32()):
                    r.i32()  # isr
                if name == topic and err == 0 and perr == 0:
                    partitions.append(pid)
        return sorted(partitions)

    def produce(
        self,
        topic: str,
        partition: int,
        records: list[tuple[bytes | None, bytes]],
    ) -> int:
        """Produce v3, acks=1; returns the base offset assigned."""
        batch = encode_record_batch(records, int(time.time() * 1000))
        body = (
            _str(None)  # transactional_id
            + struct.pack(">hi", 1, int(self.timeout * 1000))  # acks, timeout
            + struct.pack(">i", 1)  # one topic
            + _str(topic)
            + struct.pack(">i", 1)  # one partition
            + struct.pack(">i", partition)
            + _bytes(batch)
        )
        # retried via _call on transport failure: acks=1 retry-after-send
        # can duplicate, the same at-least-once contract sarama's default
        # producer retries give the reference
        r = self._call(API_PRODUCE, 3, body)
        base_offset = -1
        for _ in range(r.i32()):  # topics
            r.string()
            for _p in range(r.i32()):
                r.i32()  # partition
                err = r.i16()
                base_offset = r.i64()
                r.i64()  # log append time
                if err:
                    raise KafkaError("produce", err)
        r.i32()  # throttle_time_ms
        return base_offset

    def fetch(
        self, topic: str, partition: int, offset: int, max_bytes: int = 1 << 20
    ):
        """Fetch v4 from `offset`: ([(offset, key, value)], high_watermark)."""
        body = (
            struct.pack(">iiii", -1, 100, 1, max_bytes)  # replica, wait, min, max
            + struct.pack(">b", 0)  # isolation level: read_uncommitted
            + struct.pack(">i", 1)
            + _str(topic)
            + struct.pack(">i", 1)
            + struct.pack(">iqi", partition, offset, max_bytes)
        )
        r = self._call(API_FETCH, 4, body)
        r.i32()  # throttle
        records, high = [], 0
        for _ in range(r.i32()):
            r.string()
            for _p in range(r.i32()):
                r.i32()  # partition
                err = r.i16()
                high = r.i64()
                r.i64()  # last stable offset
                for _a in range(r.i32()):  # aborted transactions
                    r.i64(), r.i64()
                blob = r.nbytes() or b""
                if err:
                    raise KafkaError("fetch", err, high_watermark=high)
                records.extend(
                    x for x in decode_record_batches(blob) if x[0] >= offset
                )
        return records, high


# --- the notification queue -------------------------------------------------


# stable key → partition slot: the SAME blake2b router the embedded
# logqueue uses (one implementation — they must never drift; sarama's
# default hash partitioner differs, a documented deviation: both give
# per-key ordering, which is the contract)
from seaweedfs_tpu_torch.notification.logqueue import _partition_of  # noqa: E402


class KafkaQueue:
    """notification.kafka: filer events → a Kafka topic
    (notification/kafka/kafka_queue.go SendMessage: proto payload,
    path as the key)."""

    def __init__(self, hosts: str, topic: str = "seaweedfs_filer"):
        self.topic = topic
        self.client = KafkaClient(hosts)
        try:
            self.partitions = self.client.metadata(topic) or [0]
        except OSError as e:
            raise RuntimeError(
                f"notification queue 'kafka' cannot reach a broker at "
                f"{hosts!r} ({e}); start one (or the in-repo fake: "
                "python -m seaweedfs_tpu_torch.notification.kafka_fake), or use "
                "the embedded [notification.logqueue]"
            ) from e

    def send_message(self, key: str, message: fpb.EventNotification) -> None:
        # index into the partition-ID list: metadata() can return a
        # non-contiguous set (a partition mid-leader-election is
        # skipped), so the hash picks a slot, not an id
        pid = self.partitions[_partition_of(key, len(self.partitions))]
        self.client.produce(
            self.topic, pid, [(key.encode(), message.SerializeToString())]
        )

    def close(self) -> None:
        self.client.close()


class KafkaSubscriber:
    """replication/sub/notification_kafka.go role: poll (key, event)
    pairs from the topic, offsets owned by the caller."""

    def __init__(self, hosts: str, topic: str = "seaweedfs_filer"):
        self.topic = topic
        self.client = KafkaClient(hosts)
        try:
            self.partitions = self.client.metadata(topic) or [0]
        except OSError as e:
            raise RuntimeError(
                f"filer.replicate cannot reach a kafka broker at "
                f"{hosts!r} ({e}); start one (or the in-repo fake: "
                "python -m seaweedfs_tpu_torch.notification.kafka_fake), or use "
                "the embedded [notification.logqueue]"
            ) from e
        self.offsets = {p: 0 for p in self.partitions}

    def poll(self, max_records: int = 256):
        """[(partition, offset, key, EventNotification)] after the
        current offsets; advance with commit()."""
        from seaweedfs_tpu_torch.util import wlog

        out = []
        for p in self.partitions:
            if len(out) >= max_records:
                break
            try:
                records, _high = self.client.fetch(
                    self.topic, p, self.offsets[p]
                )
            except KafkaError as e:
                if e.code != KafkaError.OFFSET_OUT_OF_RANGE:
                    raise
                # broker retention trimmed past our durable offset: a
                # crash-loop helps nobody — resume at the log end and
                # say loudly what was skipped (no ListOffsets in the
                # pinned protocol subset, so log-start isn't knowable)
                wlog.error(
                    "kafka partition %d: offset %d out of range "
                    "(broker retention?); resetting to high watermark %d "
                    "— events in between are NOT replicated",
                    p, self.offsets[p], e.high_watermark,
                )
                self.offsets[p] = max(e.high_watermark, 0)
                continue
            for off, key, value in records[: max_records - len(out)]:
                ev = fpb.EventNotification()
                ev.ParseFromString(value)
                out.append((p, off, (key or b"").decode(), ev))
        return out

    def commit(self, partition: int, next_offset: int) -> None:
        self.offsets[partition] = next_offset

    def close(self) -> None:
        self.client.close()
