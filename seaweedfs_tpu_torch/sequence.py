"""File-key sequencer: allocates needle-id ranges for /dir/assign.

Behavioral match of reference weed/sequence/memory_sequencer.go: a
counter starting at 1; NextFileId(count) hands out [counter,
counter+count) and advances; SetMax lifts the counter when heartbeats
report larger keys already in use (master_grpc_server.go via
Topology). The port of seaweedfs_tpu/sequence.py: the in-memory, the
durable file-backed and the etcd-backed (etcd_sequencer.go, through
util/etcd) sequencers.
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
    """Sequencer backed by an external etcd cluster — the multi-master
    external-KV role of sequence/etcd_sequencer.go, speaking etcd's v3
    grpc-gateway REST API directly (/v3/kv/range, /v3/kv/put,
    /v3/kv/txn) instead of a client library. (The reference rides the
    long-dead etcd v2 client API; the semantics are the same: reserve
    [current, max) ranges with a compare-and-swap step bump, lift the
    stored max when heartbeats report larger keys.)

    Gated on connectivity: constructing dials the endpoint and raises
    with guidance when no etcd (or the in-repo fake,
    tests/cloud_fakes.FakeEtcd) answers."""

    KEY = "/seaweedfs/master/sequence"
    STEP = 500  # ids reserved per etcd CAS (DefaultEtcdSteps)

    def __init__(self, urls: str, step: int = STEP):
        import base64

        from seaweedfs_tpu_torch.util.etcd import EtcdKv

        self._kv = EtcdKv(urls)
        self._step = step
        self._lock = threading.Lock()
        self._key_b64 = base64.b64encode(self.KEY.encode()).decode()
        try:
            stored = self._get()
        except OSError as e:
            raise RuntimeError(
                f"etcd sequencer cannot reach {urls!r} ({e}); start etcd "
                "(or use the default file-backed sequencer via -mdir)"
            ) from e
        if stored is None:
            self._cas_create(0)
            stored = self._get() or 0
        # ids start at 1 (memory_sequencer.go convention)
        self._current = max(stored, 1)
        self._max = stored

    # --- etcd v3 gateway primitives ------------------------------------
    def _call(self, op: str, payload: dict) -> dict:
        return self._kv.call(op, payload)

    def _get(self) -> int | None:
        import base64

        resp = self._call("range", {"key": self._key_b64})
        kvs = resp.get("kvs", [])
        if not kvs:
            return None
        return int(base64.b64decode(kvs[0]["value"]))

    def _b64(self, n: int) -> str:
        import base64

        return base64.b64encode(str(n).encode()).decode()

    def _cas_create(self, value: int) -> bool:
        """Create-if-absent (createRevision == 0 compare)."""
        resp = self._call(
            "txn",
            {
                "compare": [
                    {
                        "key": self._key_b64,
                        "target": "CREATE",
                        "createRevision": "0",
                    }
                ],
                "success": [
                    {
                        "requestPut": {
                            "key": self._key_b64,
                            "value": self._b64(value),
                        }
                    }
                ],
            },
        )
        return bool(resp.get("succeeded"))

    def _cas_swap(self, prev: int, new: int) -> bool:
        resp = self._call(
            "txn",
            {
                "compare": [
                    {
                        "key": self._key_b64,
                        "target": "VALUE",
                        "value": self._b64(prev),
                    }
                ],
                "success": [
                    {
                        "requestPut": {
                            "key": self._key_b64,
                            "value": self._b64(new),
                        }
                    }
                ],
            },
        )
        return bool(resp.get("succeeded"))

    def _reserve_locked(self, at_least: int) -> None:
        """CAS-bump the stored max until [current, max) covers
        at_least ids (batchGetSequenceFromEtcd's retry loop)."""
        while self._max - self._current < at_least:
            stored = self._get()
            new_max = max(stored or 0, self._current) + max(self._step, at_least)
            if stored is None:
                # key vanished (deleted externally): a VALUE compare can
                # never match an absent key, so create-if-absent instead
                ok = self._cas_create(new_max)
            else:
                ok = self._cas_swap(stored, new_max)
            if ok:
                self._current = max(self._current, stored or 0)
                self._max = new_max

    # --- Sequencer API --------------------------------------------------
    def next_file_id(self, count: int = 1) -> int:
        with self._lock:
            self._reserve_locked(count)
            start = self._current
            self._current += count
            return start

    def set_max(self, seen_value: int) -> None:
        with self._lock:
            if seen_value < self._current:
                return
            self._current = seen_value + 1
            self._reserve_locked(1)

    def peek(self) -> int:
        with self._lock:
            return self._current
