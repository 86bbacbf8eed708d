"""Per-volume needle index: id → (offset units, size), with metrics —
the port of seaweedfs_tpu/storage/needle_map.py.

Behavioral match of reference weed/storage/needle_map.go +
needle_map_memory.go: every Put/Delete is appended to the .idx file
(the map is the .idx replayed), metrics track live/deleted counts and
bytes, deletes keep a tombstone entry.

  CompactNeedleMap  in memory (a dict), mirrored to the .idx
  DbNeedleMap       on sqlite, replaying only the .idx tail since its
                    last checkpoint (needle_map_leveldb.go's role)
  SortedNeedleMap   a read-only binary-searchable snapshot of a sorted
                    index file, the .ecx an EC volume searches
                    (needle_map_sorted_file.go, ec_volume.go:199)
"""

from __future__ import annotations

import os
import threading
from dataclasses import dataclass
from typing import Callable, Iterator, Optional

import numpy as np

from seaweedfs_tpu_torch.storage import idx as idx_codec
from seaweedfs_tpu_torch.storage import types as t


@dataclass(frozen=True)
class NeedleValue:
    key: int
    offset: int  # units of 8 bytes (types.py)
    size: int

    @property
    def actual_offset(self) -> int:
        return t.units_to_offset(self.offset)


class CompactNeedleMap:
    """In-memory map mirrored to an append-only .idx file."""

    def __init__(self, index_path: str):
        self._index_path = index_path
        self._m: dict[int, tuple[int, int]] = {}  # key -> (offset, size)
        self._index_file = None
        # mapMetric (needle_map_metric.go)
        self.file_count = 0
        self.file_byte_count = 0
        self.deletion_count = 0
        self.deletion_byte_count = 0
        self.max_file_key = 0

    # --- lifecycle ---
    @classmethod
    def load(cls, index_path: str) -> "CompactNeedleMap":
        """Replay an existing .idx (doLoading, needle_map_memory.go:30)."""
        nm = cls(index_path)
        if os.path.exists(index_path):
            with open(index_path, "rb") as f:
                data = f.read()
            for key, offset, size in idx_codec.iter_entries(data):
                nm._replay(key, offset, size)
        nm._index_file = open(index_path, "ab")
        return nm

    def _replay(self, key: int, offset: int, size: int) -> None:
        self.max_file_key = max(self.max_file_key, key)
        if offset != 0 and size != t.TOMBSTONE_FILE_SIZE:
            self.file_count += 1
            self.file_byte_count += size
            old = self._m.get(key)
            self._m[key] = (offset, size)
            if old is not None and old[0] != 0 and old[1] != t.TOMBSTONE_FILE_SIZE:
                self.deletion_count += 1
                self.deletion_byte_count += old[1]
        else:
            old_size = self._delete_in_memory(key)
            self.deletion_count += 1
            self.deletion_byte_count += old_size

    def _delete_in_memory(self, key: int) -> int:
        old = self._m.get(key)
        if old is None or old[1] == t.TOMBSTONE_FILE_SIZE:
            return 0
        self._m[key] = (old[0], t.TOMBSTONE_FILE_SIZE)
        return old[1]

    def _append_index(self, key: int, offset: int, size: int) -> None:
        if self._index_file is None:
            self._index_file = open(self._index_path, "ab")
        self._index_file.write(idx_codec.pack_entry(key, offset, size))
        self._index_file.flush()

    # --- NeedleMapper surface (needle_map.go:22-33) ---
    def put(self, key: int, offset: int, size: int) -> None:
        old = self._m.get(key)
        self._m[key] = (offset, size)
        # logPut metric accounting
        self.max_file_key = max(self.max_file_key, key)
        if old is not None and old[1] != t.TOMBSTONE_FILE_SIZE:
            self.deletion_count += 1
            self.deletion_byte_count += old[1]
        self.file_count += 1
        self.file_byte_count += size
        self._append_index(key, offset, size)

    def get(self, key: int) -> Optional[NeedleValue]:
        v = self._m.get(key)
        if v is None:
            return None
        return NeedleValue(key, v[0], v[1])

    def delete(self, key: int, offset: int) -> int:
        """Tombstone `key`; `offset` is the tombstone record's position
        in the .dat (recorded in the .idx entry). Returns freed bytes."""
        freed = self._delete_in_memory(key)
        self.deletion_count += 1
        self.deletion_byte_count += freed
        self._append_index(key, offset, t.TOMBSTONE_FILE_SIZE)
        return freed

    def ascending_visit(self, fn: Callable[[NeedleValue], None]) -> None:
        for key in sorted(self._m):
            offset, size = self._m[key]
            fn(NeedleValue(key, offset, size))

    def items(self) -> Iterator[NeedleValue]:
        for key, (offset, size) in self._m.items():
            yield NeedleValue(key, offset, size)

    def __len__(self) -> int:
        return len(self._m)

    # --- metrics surface ---
    def content_size(self) -> int:
        return self.file_byte_count

    def deleted_size(self) -> int:
        return self.deletion_byte_count

    def index_file_size(self) -> int:
        try:
            return os.path.getsize(self._index_path)
        except OSError:
            return 0

    def close(self) -> None:
        if self._index_file is not None:
            self._index_file.close()
            self._index_file = None

    def destroy(self) -> None:
        self.close()
        if os.path.exists(self._index_path):
            os.remove(self._index_path)


class SortedNeedleMap:
    """Read-only binary-searchable snapshot of a sorted index file
    (.ecx or sorted .idx) held as numpy arrays."""

    def __init__(self, keys: np.ndarray, offsets: np.ndarray, sizes: np.ndarray):
        self.keys = keys
        self.offsets = offsets
        self.sizes = sizes

    @classmethod
    def load(cls, path: str) -> "SortedNeedleMap":
        with open(path, "rb") as f:
            data = f.read()
        keys, offsets, sizes = idx_codec.entries_as_arrays(data)
        return cls(keys, offsets, sizes)

    def search(self, key: int) -> Optional[NeedleValue]:
        i = int(np.searchsorted(self.keys, np.uint64(key)))
        if i >= len(self.keys) or int(self.keys[i]) != key:
            return None
        return NeedleValue(key, int(self.offsets[i]), int(self.sizes[i]))

    def entry_index(self, key: int) -> int:
        """Index of `key`'s 16-byte entry in the backing file, or -1 —
        used to tombstone entries in place (MarkNeedleDeleted)."""
        i = int(np.searchsorted(self.keys, np.uint64(key)))
        if i >= len(self.keys) or int(self.keys[i]) != key:
            return -1
        return i

    def __len__(self) -> int:
        return len(self.keys)


class DbNeedleMap:
    """Persistent needle map on sqlite (the LevelDB variant's role,
    reference needle_map_leveldb.go:24): the key→(offset,size) table
    lives on disk, so volume load does not hold every entry in RAM and
    does not replay the whole .idx — only the tail written since the
    last checkpoint (watermark = replayed .idx byte count, the role of
    leveldb's recovery from the ldb dir).

    The .idx file stays the append-only source of truth (EC encode,
    compaction, and golden-file compatibility all read it); the db is
    a resumable index over it.
    """

    def __init__(self, index_path: str, db_path: str | None = None):
        import sqlite3

        self._index_path = index_path
        self._db_path = db_path or index_path + ".sdb"
        self._db = sqlite3.connect(self._db_path, check_same_thread=False)
        self._db.execute(
            "CREATE TABLE IF NOT EXISTS needles"
            " (key INTEGER PRIMARY KEY, offset INTEGER, size INTEGER)"
        )
        self._db.execute(
            "CREATE TABLE IF NOT EXISTS meta (k TEXT PRIMARY KEY, v INTEGER)"
        )
        self._lock = threading.Lock()
        self._index_file = None
        self._ops_since_commit = 0
        self.file_count = 0
        self.file_byte_count = 0
        self.deletion_count = 0
        self.deletion_byte_count = 0
        self.max_file_key = 0
        self._load_metrics()

    # --- lifecycle ---
    # commit cadence: per-write durability is pointless because crash
    # recovery rebuilds from the .idx anyway (the clean flag below);
    # batching commits keeps the db path near memory-map write speed
    _COMMIT_EVERY = 512

    @classmethod
    def load(cls, index_path: str, db_path: str | None = None) -> "DbNeedleMap":
        nm = cls(index_path, db_path)
        watermark = nm._meta_get("idx_bytes")
        clean = nm._meta_get("clean")
        idx_size = os.path.getsize(index_path) if os.path.exists(index_path) else 0
        if idx_size < watermark or not clean:
            # the .idx shrank (vacuum commit) or the previous process
            # died without closing: the db may hold writes the metrics/
            # watermark never checkpointed — rebuild from the .idx, the
            # source of truth (the leveldb variant's recovery role)
            nm._db.execute("DELETE FROM needles")
            nm._reset_metrics()
            watermark = 0
        if idx_size > watermark:
            with open(index_path, "rb") as f:
                f.seek(watermark)
                tail = f.read()
            for key, offset, size in idx_codec.iter_entries(tail):
                nm._replay(key, offset, size)
        nm._meta_set("idx_bytes", idx_size)
        nm._save_metrics()
        nm._meta_set("clean", 0)  # until close() checkpoints
        nm._db.commit()
        nm._index_file = open(index_path, "ab")
        return nm

    # --- meta/metrics persistence ---
    def _meta_get(self, k: str) -> int:
        row = self._db.execute("SELECT v FROM meta WHERE k=?", (k,)).fetchone()
        return int(row[0]) if row else 0

    def _meta_set(self, k: str, v: int) -> None:
        self._db.execute(
            "INSERT INTO meta (k, v) VALUES (?, ?)"
            " ON CONFLICT(k) DO UPDATE SET v=excluded.v",
            (k, v),
        )

    def _load_metrics(self) -> None:
        self.file_count = self._meta_get("file_count")
        self.file_byte_count = self._meta_get("file_byte_count")
        self.deletion_count = self._meta_get("deletion_count")
        self.deletion_byte_count = self._meta_get("deletion_byte_count")
        self.max_file_key = self._meta_get("max_file_key")

    def _save_metrics(self) -> None:
        self._meta_set("file_count", self.file_count)
        self._meta_set("file_byte_count", self.file_byte_count)
        self._meta_set("deletion_count", self.deletion_count)
        self._meta_set("deletion_byte_count", self.deletion_byte_count)
        self._meta_set("max_file_key", self.max_file_key)

    def _reset_metrics(self) -> None:
        self.file_count = 0
        self.file_byte_count = 0
        self.deletion_count = 0
        self.deletion_byte_count = 0
        self.max_file_key = 0

    # --- shared replay/accounting (mirrors CompactNeedleMap) ---
    def _db_get(self, key: int):
        row = self._db.execute(
            "SELECT offset, size FROM needles WHERE key=?", (key,)
        ).fetchone()
        return (int(row[0]), int(row[1])) if row else None

    def _db_set(self, key: int, offset: int, size: int) -> None:
        self._db.execute(
            "INSERT INTO needles (key, offset, size) VALUES (?, ?, ?)"
            " ON CONFLICT(key) DO UPDATE SET offset=excluded.offset,"
            " size=excluded.size",
            (key, offset, size),
        )

    def _replay(self, key: int, offset: int, size: int) -> None:
        # same guard as put/delete: replays arrive from the follower
        # refresh path while handler threads run get() concurrently —
        # the counters and the sqlite handle share one protection
        # (the reference lint's unguarded-write finding)
        with self._lock:
            self.max_file_key = max(self.max_file_key, key)
            if offset != 0 and size != t.TOMBSTONE_FILE_SIZE:
                self.file_count += 1
                self.file_byte_count += size
                old = self._db_get(key)
                self._db_set(key, offset, size)
                if old is not None and old[0] != 0 and old[1] != t.TOMBSTONE_FILE_SIZE:
                    self.deletion_count += 1
                    self.deletion_byte_count += old[1]
            else:
                freed = self._delete_in_db(key)
                self.deletion_count += 1
                self.deletion_byte_count += freed

    def _delete_in_db(self, key: int) -> int:
        old = self._db_get(key)
        if old is None or old[1] == t.TOMBSTONE_FILE_SIZE:
            return 0
        self._db_set(key, old[0], t.TOMBSTONE_FILE_SIZE)
        return old[1]

    def _append_index(self, key: int, offset: int, size: int) -> None:
        if self._index_file is None:
            self._index_file = open(self._index_path, "ab")
        self._index_file.write(idx_codec.pack_entry(key, offset, size))
        self._index_file.flush()

    def _maybe_commit(self) -> None:
        self._ops_since_commit += 1
        if self._ops_since_commit >= self._COMMIT_EVERY:
            self._db.commit()
            self._ops_since_commit = 0

    # --- NeedleMapper surface ---
    def put(self, key: int, offset: int, size: int) -> None:
        with self._lock:
            old = self._db_get(key)
            self._db_set(key, offset, size)
            self.max_file_key = max(self.max_file_key, key)
            if old is not None and old[1] != t.TOMBSTONE_FILE_SIZE:
                self.deletion_count += 1
                self.deletion_byte_count += old[1]
            self.file_count += 1
            self.file_byte_count += size
            self._append_index(key, offset, size)
            self._maybe_commit()

    def get(self, key: int) -> Optional[NeedleValue]:
        with self._lock:
            v = self._db_get(key)
        if v is None:
            return None
        return NeedleValue(key, v[0], v[1])

    def delete(self, key: int, offset: int) -> int:
        with self._lock:
            freed = self._delete_in_db(key)
            self.deletion_count += 1
            self.deletion_byte_count += freed
            self._append_index(key, offset, t.TOMBSTONE_FILE_SIZE)
            self._maybe_commit()
            return freed

    def ascending_visit(self, fn: Callable[[NeedleValue], None]) -> None:
        with self._lock:
            rows = self._db.execute(
                "SELECT key, offset, size FROM needles ORDER BY key"
            ).fetchall()
        for key, offset, size in rows:
            fn(NeedleValue(int(key), int(offset), int(size)))

    def items(self) -> Iterator[NeedleValue]:
        with self._lock:
            rows = self._db.execute(
                "SELECT key, offset, size FROM needles"
            ).fetchall()
        for key, offset, size in rows:
            yield NeedleValue(int(key), int(offset), int(size))

    def __len__(self) -> int:
        with self._lock:
            (n,) = self._db.execute("SELECT COUNT(*) FROM needles").fetchone()
        return int(n)

    # --- metrics surface ---
    def content_size(self) -> int:
        return self.file_byte_count

    def deleted_size(self) -> int:
        return self.deletion_byte_count

    def index_file_size(self) -> int:
        try:
            return os.path.getsize(self._index_path)
        except OSError:
            return 0

    def close(self) -> None:
        # under the map lock: close races a concurrent put/_replay from
        # a handler or follower-refresh thread during volume teardown,
        # and a half-torn _index_file/_db pair here means the checkpoint
        # below records a watermark for writes that never committed
        # (the reference lint's unguarded-write finding)
        with self._lock:
            if self._index_file is not None:
                self._index_file.close()
                self._index_file = None
            # checkpoint: metrics + watermark + clean flag in one commit;
            # a crash before this point triggers a full rebuild on load
            try:
                self._save_metrics()
                self._meta_set(
                    "idx_bytes",
                    os.path.getsize(self._index_path)
                    if os.path.exists(self._index_path)
                    else 0,
                )
                self._meta_set("clean", 1)
                self._db.commit()
                self._db.close()
            except Exception:  # noqa: BLE001 - already closed
                pass

    def destroy(self) -> None:
        self.close()
        for p in (self._index_path, self._db_path):
            if os.path.exists(p):
                os.remove(p)
