"""Embedded LSM-tree KV store: the filer's leveldb-role backend.

The reference ships leveldb/leveldb2 as its default embedded filer
stores (weed/filer2/leveldb2/leveldb2_store.go); this is the same
component built from scratch rather than bound to a C library:

  WAL  append-only write-ahead log, replayed into the memtable on open
  memtable  in-memory map, flushed to an SSTable past a size threshold
  SSTable   immutable sorted file: records + sparse index + bloom
            filter + footer; point reads binary-search the sparse
            index then scan at most `_INDEX_EVERY` records
  manifest  JSON list of live tables, swapped atomically (tmp+rename)
  compaction  when L0 grows past `_COMPACT_AT` tables, all tables merge
            into one (newest record wins, tombstones dropped — safe
            because the merge always covers the full key range)

Keys order by (directory, name) via `dir + NUL + name` encoding, the
same trick leveldb2 plays with its directory-hash prefixes: a
directory listing is one contiguous range scan in every table.

Compaction runs synchronously inside the flush that crosses the
threshold (a deliberate deviation from leveldb's background thread:
single-writer filers gain nothing from the race, and deterministic
compaction is testable).

Crash story: WAL records are length-prefixed and torn tails are
truncated on replay; SSTables are immutable and only referenced after
their manifest swap; a crash between flush and WAL reset replays
already-flushed records into the memtable, which is idempotent
(newest-wins by table order, and the memtable outranks all tables).

The port of seaweedfs_tpu/filer/lsm.py.
"""

from __future__ import annotations

import heapq
import json
import os
import struct
import threading
import zlib

from seaweedfs_tpu_torch.filer.entry import Entry, normalize_path, split_path
from seaweedfs_tpu_torch.util import durable
from seaweedfs_tpu_torch.filer.filerstore import EntryNotFound, FilerStore

_PUT, _DEL = 1, 2
_INDEX_EVERY = 16
_FOOTER = struct.Struct("<QQIQ")  # index_off, bloom_off, count, magic
_MAGIC = 0x5357_4C53_4D31_0001  # "SWLSM1"
_REC_HDR = struct.Struct("<IIB")  # klen, vlen, op
# WAL records carry a crc32 of key+value: a flipped byte mid-file would
# otherwise desync the length framing and replay garbage entries (only
# the torn *tail* is detectable by length alone)
_WAL_HDR = struct.Struct("<IIBI")  # klen, vlen, op, crc32


def _key(dir_path: str, name: str) -> bytes:
    return dir_path.encode() + b"\x00" + name.encode()


class _Bloom:
    """Fixed double-hash bloom filter (k=4, ~10 bits/key).

    Hashes must be process-independent (the bits are persisted and
    reread by later processes; Python's builtin hash() is seeded per
    process and would turn into false negatives = lost keys), so they
    come from one blake2b digest split in half."""

    def __init__(self, bits: bytearray):
        self.bits = bits

    @classmethod
    def build(cls, keys: list[bytes]) -> "_Bloom":
        nbits = max(64, len(keys) * 10)
        bits = bytearray((nbits + 7) // 8)
        b = cls(bits)
        for k in keys:
            for h in b._hashes(k):
                bits[h // 8] |= 1 << (h % 8)
        return b

    def _hashes(self, key: bytes):
        import hashlib

        nbits = len(self.bits) * 8
        d = hashlib.blake2b(key, digest_size=8).digest()
        h1 = int.from_bytes(d[:4], "little")
        h2 = int.from_bytes(d[4:], "little") or 1
        for i in range(4):
            yield (h1 + i * h2) % nbits

    def __contains__(self, key: bytes) -> bool:
        return all(self.bits[h // 8] >> (h % 8) & 1 for h in self._hashes(key))


class _SSTable:
    """One immutable sorted table; sparse index + bloom held in memory."""

    def __init__(self, path: str):
        self.path = path
        self._f = open(path, "rb")
        self._f.seek(-_FOOTER.size, os.SEEK_END)
        index_off, bloom_off, self.count, magic = _FOOTER.unpack(
            self._f.read(_FOOTER.size)
        )
        if magic != _MAGIC:
            raise ValueError(f"bad sstable magic in {path}")
        self._f.seek(index_off)
        raw_index = self._f.read(bloom_off - index_off)
        self.index: list[tuple[bytes, int]] = []  # (key, record offset)
        pos = 0
        while pos < len(raw_index):
            klen, off = struct.unpack_from("<IQ", raw_index, pos)
            pos += 12
            self.index.append((raw_index[pos : pos + klen], off))
            pos += klen
        self._f.seek(bloom_off)
        bloom_raw = self._f.read(
            os.path.getsize(path) - bloom_off - _FOOTER.size
        )
        self.bloom = _Bloom(bytearray(bloom_raw))
        self._data_end = index_off
        self._lock = threading.Lock()

    @staticmethod
    def write(path: str, records: list[tuple[bytes, int, bytes]]) -> None:
        """records: sorted (key, op, value). Atomic via tmp+rename."""
        tmp = path + ".tmp"
        with open(tmp, "wb") as f:
            index = []
            for i, (k, op, v) in enumerate(records):
                if i % _INDEX_EVERY == 0:
                    index.append((k, f.tell()))
                f.write(_REC_HDR.pack(len(k), len(v), op) + k + v)
            index_off = f.tell()
            for k, off in index:
                f.write(struct.pack("<IQ", len(k), off) + k)
            bloom_off = f.tell()
            f.write(bytes(_Bloom.build([k for k, _, _ in records]).bits))
            f.write(_FOOTER.pack(index_off, bloom_off, len(records), _MAGIC))
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp, path)
        durable.fsync_dir(os.path.dirname(path) or ".")

    def _scan_from(self, offset: int):
        """Yield (key, op, value) records starting at a record offset.
        Caller holds self._lock."""
        self._f.seek(offset)
        pos = offset
        while pos < self._data_end:
            hdr = self._f.read(_REC_HDR.size)
            klen, vlen, op = _REC_HDR.unpack(hdr)
            k = self._f.read(klen)
            v = self._f.read(vlen)
            pos += _REC_HDR.size + klen + vlen
            yield k, op, v

    def _seek_offset(self, key: bytes) -> int:
        """Record offset of the sparse-index slot at or before `key`."""
        lo, hi = 0, len(self.index) - 1
        best = 0
        while lo <= hi:
            mid = (lo + hi) // 2
            if self.index[mid][0] <= key:
                best = self.index[mid][1]
                lo = mid + 1
            else:
                hi = mid - 1
        return best

    def get(self, key: bytes) -> tuple[int, bytes] | None:
        """(op, value) for key, or None. Bloom-gated point read."""
        if not self.index or key not in self.bloom:
            return None
        with self._lock:
            for k, op, v in self._scan_from(self._seek_offset(key)):
                if k == key:
                    return op, v
                if k > key:
                    return None
        return None

    def iter_range(self, start_key: bytes, end_key: bytes | None = None):
        """Stream records with start_key <= key (< end_key when given).

        Opens a private file handle EAGERLY (before returning the
        generator): callers invoke this under the store lock, so a
        concurrent compaction cannot unlink the path before the open —
        and once open, the fd keeps the unlinked inode readable for the
        rest of the (lockless, lazy) iteration. The table bytes are
        immutable, so no further locking is needed; a paginated listing
        stops after its page instead of materializing the directory's
        tail."""
        if not self.index:
            return iter(())
        f = open(self.path, "rb")

        def gen():
            with f:
                pos = self._seek_offset(start_key)
                f.seek(pos)
                while pos < self._data_end:
                    klen, vlen, op = _REC_HDR.unpack(f.read(_REC_HDR.size))
                    k = f.read(klen)
                    v = f.read(vlen)
                    pos += _REC_HDR.size + klen + vlen
                    if end_key is not None and k >= end_key:
                        return
                    if k >= start_key:
                        yield k, op, v

        return gen()

    def range_from(
        self, start_key: bytes, end_key: bytes | None = None
    ) -> list[tuple[bytes, int, bytes]]:
        """Materialized iter_range (compaction wants the whole table)."""
        return list(self.iter_range(start_key, end_key))

    def close(self) -> None:
        self._f.close()


class LsmStore(FilerStore):
    """FilerStore over the LSM engine. `path` is a directory."""

    name = "lsm"

    def __init__(
        self,
        path: str,
        memtable_bytes: int = 4 * 1024 * 1024,
        compact_at: int = 4,
    ):
        self._dir = path
        self._memtable_bytes = memtable_bytes
        self._compact_at = compact_at
        os.makedirs(path, exist_ok=True)
        self._lock = threading.RLock()
        self._mem: dict[bytes, tuple[int, bytes]] = {}  # key -> (op, value)
        self._mem_size = 0
        self._next_table = 1
        self._tables: list[_SSTable] = []  # oldest → newest
        self._load_manifest()
        self._wal_path = os.path.join(path, "wal.log")
        self._replay_wal()
        self._wal = open(self._wal_path, "ab")

    # --- persistence plumbing ---

    def _manifest_path(self) -> str:
        return os.path.join(self._dir, "MANIFEST")

    def _load_manifest(self) -> None:
        try:
            with open(self._manifest_path()) as f:
                names = json.load(f)
        except (OSError, ValueError):
            names = []
        for n in names:
            p = os.path.join(self._dir, n)
            if os.path.exists(p):
                self._tables.append(_SSTable(p))
                num = int(n.split(".")[0])
                self._next_table = max(self._next_table, num + 1)

    def _write_manifest(self) -> None:
        tmp = self._manifest_path() + ".tmp"
        with open(tmp, "w") as f:
            json.dump([os.path.basename(t.path) for t in self._tables], f)
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp, self._manifest_path())
        durable.fsync_dir(self._dir)

    def _replay_wal(self) -> None:
        if not os.path.exists(self._wal_path):
            return
        good = 0
        with open(self._wal_path, "rb") as f:
            raw = f.read()
        pos = 0
        while pos + _WAL_HDR.size <= len(raw):
            klen, vlen, op, crc = _WAL_HDR.unpack_from(raw, pos)
            end = pos + _WAL_HDR.size + klen + vlen
            if end > len(raw):
                break  # torn tail
            k = raw[pos + _WAL_HDR.size : pos + _WAL_HDR.size + klen]
            v = raw[pos + _WAL_HDR.size + klen : end]
            if zlib.crc32(v, zlib.crc32(k)) != crc:
                break  # corrupt record: cut here, like a torn tail
            self._mem[k] = (op, v)
            self._mem_size += len(k) + len(v) + 16
            good = end
            pos = end
        if good < len(raw):  # truncate the torn tail for the next append
            with open(self._wal_path, "r+b") as f:
                f.truncate(good)

    def _wal_append(self, key: bytes, op: int, value: bytes) -> None:
        crc = zlib.crc32(value, zlib.crc32(key))
        self._wal.write(
            _WAL_HDR.pack(len(key), len(value), op, crc) + key + value
        )
        self._wal.flush()

    def _flush_memtable(self) -> None:
        """Memtable → new L0 SSTable; maybe compact; reset WAL.
        Caller holds self._lock."""
        if not self._mem:
            return
        records = [(k, op, v) for k, (op, v) in sorted(self._mem.items())]
        name = f"{self._next_table:06d}.sst"
        self._next_table += 1
        path = os.path.join(self._dir, name)
        _SSTable.write(path, records)
        self._tables.append(_SSTable(path))
        if len(self._tables) >= self._compact_at:
            self._compact()
        else:
            self._write_manifest()
        self._mem.clear()
        self._mem_size = 0
        # reset the WAL only after the manifest references the table
        self._wal.close()
        self._wal = open(self._wal_path, "wb")

    def _compact(self) -> None:
        """Merge all tables, newest wins, tombstones dropped.
        Caller holds self._lock."""
        merged: dict[bytes, tuple[int, bytes]] = {}
        for t in self._tables:  # oldest → newest: later writes win
            for k, op, v in t.range_from(b""):
                merged[k] = (op, v)
        records = [
            (k, op, v)
            for k, (op, v) in sorted(merged.items())
            if op != _DEL
        ]
        name = f"{self._next_table:06d}.sst"
        self._next_table += 1
        path = os.path.join(self._dir, name)
        _SSTable.write(path, records)
        old = self._tables
        self._tables = [_SSTable(path)]
        self._write_manifest()
        for t in old:
            t.close()
            try:
                os.unlink(t.path)
            except OSError:
                pass

    def _put(self, key: bytes, op: int, value: bytes) -> None:
        with self._lock:
            self._wal_append(key, op, value)
            self._mem[key] = (op, value)
            self._mem_size += len(key) + len(value) + 16
            if self._mem_size >= self._memtable_bytes:
                self._flush_memtable()

    def _get(self, key: bytes) -> bytes | None:
        with self._lock:
            hit = self._mem.get(key)
            if hit is None:
                for t in reversed(self._tables):  # newest first
                    got = t.get(key)
                    if got is not None:
                        hit = got
                        break
        if hit is None or hit[0] == _DEL:
            return None
        return hit[1]

    # --- FilerStore SPI ---

    def insert_entry(self, entry: Entry) -> None:
        d, name = split_path(entry.full_path)
        self._put(_key(d, name), _PUT, entry.encode())

    update_entry = insert_entry

    def find_entry(self, full_path: str) -> Entry:
        d, name = split_path(full_path)
        data = self._get(_key(d, name))
        if data is None:
            raise EntryNotFound(full_path)
        return Entry.decode(full_path, data)

    def delete_entry(self, full_path: str) -> None:
        d, name = split_path(full_path)
        self._put(_key(d, name), _DEL, b"")

    def list_directory_entries(
        self, dir_path: str, start_file_name: str, include_start: bool, limit: int
    ) -> list[Entry]:
        dir_path = normalize_path(dir_path)
        prefix = dir_path.encode() + b"\x00"
        start = prefix + start_file_name.encode()
        # NUL separates dir from name, so dir+0x01 upper-bounds the
        # directory's whole key range
        end = dir_path.encode() + b"\x01"
        # limit-aware k-way merge, newest-wins per key: each source is
        # already sorted; priority = source recency (memtable > newer
        # table > older). Stops as soon as the page is full instead of
        # materializing the directory's tail (tables stream lazily via
        # iter_range; only the memtable — bounded by memtable_bytes —
        # is snapshotted here). Sources are BUILT under the lock:
        # iter_range opens its file handle eagerly, so a concurrent
        # flush-triggered compaction can't unlink a snapshotted table
        # out from under the merge.
        def _table_source(t: _SSTable, pri: int):
            # explicit binding: a genexp inside the list comprehension
            # would close over the loop variable and give every source
            # the LAST priority, letting ties fall to op where
            # PUT < DEL — i.e. deletes resurrected across tables
            it = t.iter_range(start, end)  # opens the fd now, under the lock
            return ((k, -pri, op, v) for k, op, v in it)

        with self._lock:
            n_tables = len(self._tables)
            sources = [
                _table_source(t, pri) for pri, t in enumerate(self._tables)
            ]
            sources.append(
                iter(
                    sorted(
                        (k, -n_tables, op, v)
                        for k, (op, v) in self._mem.items()
                        if start <= k < end
                    )
                )
            )
        out = []
        current: bytes | None = None
        for k, neg_pri, op, v in heapq.merge(*sources):
            if k == current:
                continue  # a newer source already decided this key
            current = k
            if op == _DEL:
                continue
            name = k[len(prefix) :].decode()
            if start_file_name:
                if include_start and name < start_file_name:
                    continue
                if not include_start and name <= start_file_name:
                    continue
            out.append(Entry.decode(f"{dir_path}/{name}", v))
            if len(out) >= limit:
                break
        return out

    def flush(self) -> None:
        """Force the memtable to disk (test/shutdown hook)."""
        with self._lock:
            self._flush_memtable()

    def close(self) -> None:
        with self._lock:
            self._flush_memtable()
            self._wal.close()
            for t in self._tables:
                t.close()
