"""File-key sequencer: allocates needle-id ranges for /dir/assign.

Behavioral match of reference weed/sequence/memory_sequencer.go: a
counter starting at 1; NextFileId(count) hands out [counter,
counter+count) and advances; SetMax lifts the counter when heartbeats
report larger keys already in use (master_grpc_server.go via
Topology). The port of seaweedfs_tpu/sequence.py: the in-memory and
the durable file-backed sequencers; the etcd-backed variant
(etcd_sequencer.go) raises until util/etcd is ported (ROADMAP item 5).
"""

from __future__ import annotations

import threading

from seaweedfs_tpu_torch.util import durable


class MemorySequencer:
    def __init__(self, start: int = 1):
        self._counter = start
        self._lock = threading.Lock()

    def next_file_id(self, count: int = 1) -> int:
        """Returns the first id of a freshly reserved range of `count`."""
        with self._lock:
            start = self._counter
            self._counter += count
            return start

    def set_max(self, seen_value: int) -> None:
        # '>=' so a reported key equal to the counter advances past it
        # (memory_sequencer.go:28 `counter <= value`) — otherwise the
        # next assign re-issues an id already on disk.
        with self._lock:
            if seen_value >= self._counter:
                self._counter = seen_value + 1

    def peek(self) -> int:
        with self._lock:
            return self._counter


class FileSequencer:
    """Durable sequencer: the counter survives master restarts the way
    the reference's EtcdSequencer does (sequence/etcd_sequencer.go) —
    without an external KV store, the durable medium is a local file.

    Ranges are reserved in batches: the file stores the upper bound of
    the reserved range, so one fsync covers `batch` allocations and a
    crash only skips ids (never reuses them) — the same no-reuse
    guarantee etcd leases give the reference."""

    BATCH = 10000  # ids reserved per durable write (etcd_sequencer.go step)

    def __init__(self, path: str, batch: int = BATCH):
        import os

        self._path = path
        self._batch = batch
        self._lock = threading.Lock()
        reserved = 0
        if os.path.exists(path):
            try:
                with open(path) as f:
                    reserved = int(f.read().strip() or 0)
            except (OSError, ValueError):
                reserved = 0
        # resume past everything previously reserved: ids in (counter,
        # reserved] may or may not have been handed out pre-crash
        self._counter = reserved + 1
        self._reserved = reserved
        self._ensure_reserved_locked()

    def _ensure_reserved_locked(self) -> None:
        import os

        if self._counter <= self._reserved:
            return  # still inside the durably reserved range
        self._reserved = self._counter + self._batch
        tmp = self._path + ".tmp"
        with open(tmp, "w") as f:
            f.write(str(self._reserved))
        # fsync + rename + dir fsync: a reservation that does not
        # survive the crash can re-issue file ids the old process
        # already handed out
        durable.publish(tmp, self._path)

    def next_file_id(self, count: int = 1) -> int:
        with self._lock:
            start = self._counter
            self._counter += count
            self._ensure_reserved_locked()
            return start

    def set_max(self, seen_value: int) -> None:
        with self._lock:
            if seen_value >= self._counter:
                self._counter = seen_value + 1
                self._ensure_reserved_locked()

    def peek(self) -> int:
        with self._lock:
            return self._counter


class EtcdSequencer:
    """Sequencer backed by an external etcd cluster (the external-KV
    role of sequence/etcd_sequencer.go). The port keeps its name and
    constants; constructing one raises until util/etcd is ported
    (ROADMAP item 5)."""

    KEY = "/seaweedfs/master/sequence"
    STEP = 500  # ids reserved per etcd CAS (DefaultEtcdSteps)

    def __init__(self, urls: str, step: int = STEP):
        raise NotImplementedError(
            "EtcdSequencer needs util/etcd, which is not ported yet "
            "(ROADMAP item 5); the master's default sequencers are "
            "MemorySequencer and the file-backed FileSequencer (-mdir)"
        )
