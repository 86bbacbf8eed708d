"""Partitioned durable log queue: the broker the reference outsources.

The reference's cross-cluster replication rides an external broker
(Kafka/SQS/PubSub, weed/notification/configuration.go); this is the
same capability as an embedded component, so replication runs durably
with zero external services:

  partitions  fixed count; a message goes to partition
              blake2b(key) % P (stable across processes — the same
              key always lands in the same partition, preserving
              per-path event order like Kafka's key partitioning)
  segments    per-partition append-only files named by base offset,
              rolled past `segment_bytes`; records are
              (len, crc32, payload) so torn tails and corruption are
              detected and cut at replay
  offsets     per-(group, partition) committed offset files, swapped
              atomically — consumer groups poll from their offset and
              commit after processing (at-least-once, Kafka semantics)
  trim()      drops whole segments below the minimum committed offset
              across all groups (retention by consumption)

Everything is plain files under one directory, so producer (filer
process) and consumers (`weed filer.replicate` processes) coordinate
cross-process through the filesystem the way the reference's
processes coordinate through a broker.

The port of seaweedfs_tpu/notification/logqueue.py. The on-disk format
is the same (meta.json, p<NNN>/<base offset>.seg, p<NNN>/offsets/<group>),
so either package reads a queue directory the other wrote.
"""

from __future__ import annotations

import hashlib
import json
import os
import struct
import threading
import time
import zlib

from seaweedfs_tpu_torch.pb import filer_pb2 as fpb
from seaweedfs_tpu_torch.util import durable
from seaweedfs_tpu_torch.util import wlog

_REC = struct.Struct("<II")  # payload length, crc32


def _partition_of(key: str, partitions: int) -> int:
    d = hashlib.blake2b(key.encode(), digest_size=4).digest()
    return int.from_bytes(d, "little") % partitions


class _Partition:
    """One partition: segment files + append head. Offsets are logical
    record indices, monotonic from 0."""

    def __init__(self, directory: str, segment_bytes: int):
        self.dir = directory
        self.segment_bytes = segment_bytes
        os.makedirs(os.path.join(directory, "offsets"), exist_ok=True)
        self._lock = threading.Lock()
        # (base_offset, path, record_count) oldest → newest
        self.segments: list[tuple[int, str, int]] = []
        self._scan()
        self._active: "object | None" = None  # open file for appends

    def _scan(self) -> None:
        names = sorted(
            n for n in os.listdir(self.dir) if n.endswith(".seg")
        )
        for name in names:
            base = int(name.split(".")[0])
            path = os.path.join(self.dir, name)
            count = sum(1 for _ in _read_segment(path))
            self.segments.append((base, path, count))

    def _refresh(self) -> None:
        """Re-sync the segment view with the directory: a consumer
        process must see segments rolled — and records appended to the
        tail segment — by the producer process after open. Sealed
        segments are immutable, so only the cached tail is re-counted.
        Caller holds self._lock."""
        if self.segments:
            base, path, _ = self.segments[-1]
            self.segments[-1] = (
                base,
                path,
                sum(1 for _ in _read_segment(path)),
            )
        known = {path for _, path, _ in self.segments}
        names = sorted(n for n in os.listdir(self.dir) if n.endswith(".seg"))
        for name in names:
            path = os.path.join(self.dir, name)
            if path in known:
                continue
            base = int(name.split(".")[0])
            if self.segments and base < self.segments[-1][0]:
                continue  # trimmed-then-recreated can't happen; ignore stragglers
            count = sum(1 for _ in _read_segment(path))
            self.segments.append((base, path, count))

    @property
    def next_offset(self) -> int:
        if not self.segments:
            return 0
        base, _, count = self.segments[-1]
        return base + count

    def refreshed_next_offset(self) -> int:
        """next_offset after syncing with segments written by other
        processes (consumer-side lag accounting)."""
        with self._lock:
            self._refresh()
            return self.next_offset

    def append(self, payload: bytes) -> int:
        with self._lock:
            offset = self.next_offset
            if (
                self._active is None
                or self._active_size() >= self.segment_bytes
            ):
                self._roll(offset)
            self._active.write(
                _REC.pack(len(payload), zlib.crc32(payload)) + payload
            )
            self._active.flush()
            base, path, count = self.segments[-1]
            self.segments[-1] = (base, path, count + 1)
            return offset

    def _active_size(self) -> int:
        return self._active.tell() if self._active else 0

    def _roll(self, base_offset: int) -> None:
        if self._active is not None:
            self._active.close()
        path = os.path.join(self.dir, f"{base_offset:020d}.seg")
        self._active = open(path, "ab")
        if not self.segments or self.segments[-1][1] != path:
            self.segments.append((base_offset, path, 0))

    def read_from(self, offset: int, max_records: int):
        """[(offset, payload)] starting at logical `offset`."""
        out = []
        with self._lock:
            self._refresh()
            segs = list(self.segments)
        for base, path, count in segs:
            if base + count <= offset:
                continue
            for i, payload in enumerate(_read_segment(path)):
                o = base + i
                if o < offset:
                    continue
                out.append((o, payload))
                if len(out) >= max_records:
                    return out
        return out

    # --- consumer-group offsets ---

    def _offset_path(self, group: str) -> str:
        safe = "".join(c if c.isalnum() or c in "-_." else "_" for c in group)
        return os.path.join(self.dir, "offsets", safe)

    def committed(self, group: str) -> int:
        try:
            with open(self._offset_path(group)) as f:
                return int(f.read().strip() or "0")
        except (OSError, ValueError):
            return 0

    def register(self, group: str) -> None:
        """Materialize a zero offset for a group that has never
        committed, so trim()'s low-water mark accounts for it from its
        first poll — otherwise its unread segments could be deleted out
        from under it by groups that are further ahead. (A group that
        has never even polled still starts at the oldest retained
        segment, Kafka-style retention-by-consumption.)

        For an existing offset file this refreshes its mtime: polling
        is the liveness signal trim()'s staleness cutoff reads, so an
        abandoned group (one-off diagnostic poll, decommissioned
        consumer) stops pinning retention once it goes quiet."""
        p = self._offset_path(group)
        if os.path.exists(p):
            try:
                os.utime(p)
            except OSError:
                pass
        else:
            self.commit(group, 0)

    def commit(self, group: str, offset: int) -> None:
        p = self._offset_path(group)
        tmp = p + ".tmp"
        with open(tmp, "w") as f:
            f.write(str(offset))
        # durable publish: a lost cursor re-delivers from the previous
        # commit (at-least-once holds), but a TORN one parse-fails and
        # restarts the group from zero
        durable.publish(tmp, p)

    def groups(self) -> list[str]:
        return os.listdir(os.path.join(self.dir, "offsets"))

    def trim(self, stale_after: float | None = None) -> int:
        """Delete whole segments every live group has consumed. Returns
        the number of segments removed. Never removes the active
        segment. Groups whose offset file hasn't been touched (by a
        commit or a poll's register) in `stale_after` seconds are
        treated as abandoned and stop pinning retention."""
        groups = self.groups()
        if not groups:
            return 0
        now = time.time()
        low = None
        for g in groups:
            if stale_after is not None:
                try:
                    mtime = os.stat(self._offset_path(g)).st_mtime
                except OSError:
                    continue
                if now - mtime > stale_after:
                    continue
            off = self.committed(g)
            low = off if low is None else min(low, off)
        if low is None:
            return 0
        removed = 0
        with self._lock:
            while len(self.segments) > 1:
                base, path, count = self.segments[0]
                if base + count > low:
                    break
                try:
                    os.unlink(path)
                except OSError:
                    pass
                self.segments.pop(0)
                removed += 1
        return removed

    def close(self) -> None:
        with self._lock:
            if self._active is not None:
                self._active.close()
                self._active = None


def _read_segment(path: str):
    """Yield payloads; stop at a torn or corrupt record (and warn)."""
    try:
        with open(path, "rb") as f:
            while True:
                hdr = f.read(_REC.size)
                if len(hdr) < _REC.size:
                    break
                length, crc = _REC.unpack(hdr)
                payload = f.read(length)
                if len(payload) < length:
                    wlog.warning("logqueue: torn record tail in %s", path)
                    break
                if zlib.crc32(payload) != crc:
                    wlog.warning("logqueue: crc mismatch in %s; cut here", path)
                    break
                yield payload
    except OSError:
        return


class PartitionedLogQueue:
    """NotificationQueue + consumer API (see module docstring)."""

    def __init__(
        self,
        directory: str,
        partitions: int = 4,
        segment_bytes: int = 8 * 1024 * 1024,
        stale_group_seconds: float = 24 * 3600.0,
    ):
        self.stale_group_seconds = stale_group_seconds
        if partitions < 1:
            raise ValueError("partitions must be >= 1")
        self.dir = directory
        # the partition count is a property of the on-disk queue, not of
        # whoever opens it: key→partition routing and the p* directory
        # set are fixed at creation, so a later config change must not
        # silently strand messages in unreferenced partition dirs
        os.makedirs(directory, exist_ok=True)
        meta_path = os.path.join(directory, "meta.json")
        try:
            with open(meta_path) as f:
                existing = int(json.load(f)["partitions"])
        except (OSError, ValueError, KeyError):
            existing = 0
        if existing:
            if existing != partitions:
                wlog.warning(
                    "logqueue %s was created with %d partitions; "
                    "ignoring configured %d",
                    directory,
                    existing,
                    partitions,
                )
            partitions = existing
        else:
            tmp = meta_path + ".tmp"
            with open(tmp, "w") as f:
                json.dump({"partitions": partitions}, f)
            # partition count is immutable once chosen; the meta file
            # must survive the crash or a restart re-partitions and
            # strands every queued message
            durable.publish(tmp, meta_path)
        self.partitions = [
            _Partition(os.path.join(directory, f"p{i:03d}"), segment_bytes)
            for i in range(partitions)
        ]

    # --- producer side (notification.Queue role) ---

    def send_message(self, key: str, message: fpb.EventNotification) -> None:
        header = json.dumps({"key": key, "ts": time.time()}).encode()
        payload = (
            len(header).to_bytes(4, "big") + header + message.SerializeToString()
        )
        self.partitions[_partition_of(key, len(self.partitions))].append(payload)

    # --- consumer side ---

    @staticmethod
    def _decode(payload: bytes) -> tuple[str, fpb.EventNotification]:
        hlen = int.from_bytes(payload[:4], "big")
        header = json.loads(payload[4 : 4 + hlen])
        msg = fpb.EventNotification()
        msg.ParseFromString(payload[4 + hlen :])
        return header["key"], msg

    def poll(self, group: str, max_records: int = 256):
        """[(partition, offset, key, message)] after `group`'s committed
        offsets; at-least-once — call commit() per partition after
        processing. Fairness: each partition first gets an equal share
        of max_records (so one hot partition can't starve the rest),
        then leftover budget is filled from whatever has more."""
        quota = max(1, max_records // len(self.partitions))
        out = []
        budget = max_records
        leftovers = []
        for p in self.partitions:
            p.register(group)  # first poll pins the trim low-water mark
        for i, p in enumerate(self.partitions):
            if budget <= 0:
                break
            take = min(quota, budget)
            got = p.read_from(p.committed(group), take + 1)
            for o, payload in got[:take]:
                key, msg = self._decode(payload)
                out.append((i, o, key, msg))
                budget -= 1
            if len(got) > take:  # partition has more than its share
                leftovers.append(i)
        for i in leftovers:
            if budget <= 0:
                break
            p = self.partitions[i]
            start = max(
                (o for pt, o, _, _ in out if pt == i), default=p.committed(group) - 1
            ) + 1
            for o, payload in p.read_from(start, budget):
                key, msg = self._decode(payload)
                out.append((i, o, key, msg))
                budget -= 1
        return out

    def commit(self, group: str, partition: int, next_offset: int) -> None:
        """Record that `group` has processed everything below
        `next_offset` in `partition`."""
        self.partitions[partition].commit(group, next_offset)

    def committed(self, group: str, partition: int) -> int:
        return self.partitions[partition].committed(group)

    def trim(self) -> int:
        return sum(p.trim(self.stale_group_seconds) for p in self.partitions)

    def depth(self, group: str) -> int:
        """Unconsumed record count for a group (lag), synced with
        segments written by other processes."""
        return sum(
            max(0, p.refreshed_next_offset() - p.committed(group))
            for p in self.partitions
        )

    def close(self) -> None:
        for p in self.partitions:
            p.close()
