"""FilerStore SPI + embedded implementations.

Behavioral match of weed/filer2/filerstore.go (9-method CRUD+list+tx
interface) with three embedded stores standing in for the reference's
8 pluggable KV backends:

  * MemoryStore  — dict-backed, for tests (≈ the reference's memdb)
  * SqliteStore  — stdlib sqlite3, same schema shape as the
    abstract_sql mysql/postgres stores (dirhash+name primary key,
    filer2/abstract_sql/abstract_sql_store.go)
  * SortedLogStore — append-only log + in-memory sorted index,
    leveldb-analogue persistence without a leveldb dependency
    (filer2/leveldb2/)

All store keys are (directory, name); values are the Entry pb codec
bytes (entry_codec.go).

The port of seaweedfs_tpu/filer/filerstore.py.
"""

from __future__ import annotations

import os
import sqlite3
import struct
import threading

from seaweedfs_tpu_torch.filer.entry import Entry, child_path, normalize_path, split_path


class EntryNotFound(KeyError):
    pass


class FilerStore:
    """SPI (filerstore.go:13-29)."""

    name = "abstract"

    def insert_entry(self, entry: Entry) -> None:
        raise NotImplementedError

    def update_entry(self, entry: Entry) -> None:
        raise NotImplementedError

    def find_entry(self, full_path: str) -> Entry:
        raise NotImplementedError

    def delete_entry(self, full_path: str) -> None:
        raise NotImplementedError

    def delete_folder_children(self, full_path: str) -> None:
        for e in self.list_directory_entries(full_path, "", True, 1 << 30):
            self.delete_entry(e.full_path)

    def list_directory_entries(
        self, dir_path: str, start_file_name: str, include_start: bool, limit: int
    ) -> list[Entry]:
        raise NotImplementedError

    # tx hooks; embedded stores are single-process so default no-ops
    def begin_transaction(self) -> None: ...

    def commit_transaction(self) -> None: ...

    def rollback_transaction(self) -> None: ...

    def close(self) -> None: ...


class MemoryStore(FilerStore):
    name = "memory"

    def __init__(self) -> None:
        self._lock = threading.RLock()
        # dir -> {name: encoded entry}
        self._dirs: dict[str, dict[str, bytes]] = {}

    def insert_entry(self, entry: Entry) -> None:
        d, name = split_path(entry.full_path)
        with self._lock:
            self._dirs.setdefault(d, {})[name] = entry.encode()

    update_entry = insert_entry

    def find_entry(self, full_path: str) -> Entry:
        d, name = split_path(full_path)
        with self._lock:
            data = self._dirs.get(d, {}).get(name)
        if data is None:
            raise EntryNotFound(full_path)
        return Entry.decode(full_path, data)

    def delete_entry(self, full_path: str) -> None:
        d, name = split_path(full_path)
        with self._lock:
            self._dirs.get(d, {}).pop(name, None)

    def list_directory_entries(self, dir_path, start_file_name, include_start, limit):
        dir_path = normalize_path(dir_path)
        with self._lock:
            names = sorted(self._dirs.get(dir_path, {}))
            out = []
            for n in names:
                if start_file_name:
                    if include_start and n < start_file_name:
                        continue
                    if not include_start and n <= start_file_name:
                        continue
                out.append(
                    Entry.decode(child_path(dir_path, n), self._dirs[dir_path][n])
                )
                if len(out) >= limit:
                    break
        return out


class SqliteStore(FilerStore):
    """abstract_sql-equivalent store on stdlib sqlite3
    (filer2/abstract_sql/abstract_sql_store.go: INSERT/UPDATE/DELETE/
    SELECT ... WHERE dirhash=? AND name=?; list by dirhash+name>)."""

    name = "sqlite"

    def __init__(self, path: str = ":memory:") -> None:
        self._conn = sqlite3.connect(path, check_same_thread=False)
        self._lock = threading.RLock()
        self._tx_depth = 0  # >0: inside begin/commit_transaction, defer commits
        self._conn.execute(
            "CREATE TABLE IF NOT EXISTS filemeta ("
            " directory TEXT NOT NULL,"
            " name TEXT NOT NULL,"
            " meta BLOB,"
            " PRIMARY KEY (directory, name))"
        )
        self._conn.commit()

    def insert_entry(self, entry: Entry) -> None:
        d, name = split_path(entry.full_path)
        with self._lock:
            self._conn.execute(
                "INSERT OR REPLACE INTO filemeta (directory, name, meta) VALUES (?,?,?)",
                (d, name, entry.encode()),
            )
            if self._tx_depth == 0:
                self._conn.commit()

    update_entry = insert_entry

    def find_entry(self, full_path: str) -> Entry:
        d, name = split_path(full_path)
        with self._lock:
            row = self._conn.execute(
                "SELECT meta FROM filemeta WHERE directory=? AND name=?", (d, name)
            ).fetchone()
        if row is None:
            raise EntryNotFound(full_path)
        return Entry.decode(full_path, row[0])

    def delete_entry(self, full_path: str) -> None:
        d, name = split_path(full_path)
        with self._lock:
            self._conn.execute(
                "DELETE FROM filemeta WHERE directory=? AND name=?", (d, name)
            )
            if self._tx_depth == 0:
                self._conn.commit()

    def delete_folder_children(self, full_path: str) -> None:
        d = normalize_path(full_path)
        with self._lock:
            self._conn.execute("DELETE FROM filemeta WHERE directory=?", (d,))
            if self._tx_depth == 0:
                self._conn.commit()

    def list_directory_entries(self, dir_path, start_file_name, include_start, limit):
        d = normalize_path(dir_path)
        op = ">=" if include_start else ">"
        with self._lock:
            rows = self._conn.execute(
                f"SELECT name, meta FROM filemeta WHERE directory=? AND name {op} ?"
                " ORDER BY name LIMIT ?",
                (d, start_file_name, limit),
            ).fetchall()
        return [Entry.decode(child_path(d, name), meta) for name, meta in rows]

    def begin_transaction(self) -> None:
        # per-op commits are deferred while _tx_depth > 0 so a rollback
        # really undoes the whole transaction (atomic_rename contract)
        self._lock.acquire()
        self._tx_depth += 1

    def commit_transaction(self) -> None:
        self._tx_depth -= 1
        if self._tx_depth == 0:
            self._conn.commit()
        self._lock.release()

    def rollback_transaction(self) -> None:
        self._tx_depth -= 1
        self._conn.rollback()
        self._lock.release()

    def close(self) -> None:
        self._conn.close()


class SortedLogStore(FilerStore):
    """Append-only record log + in-memory sorted index; replayed on
    open. Persistence role of the reference's leveldb store without the
    dependency: every insert/delete appends (op, path, meta) records."""

    name = "sortedlog"

    _PUT, _DEL = 1, 2

    def __init__(self, path: str) -> None:
        self._path = path
        self._mem = MemoryStore()
        self._lock = threading.Lock()
        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
        self._replay()
        self._f = open(path, "ab")

    def _replay(self) -> None:
        if not os.path.exists(self._path):
            return
        with open(self._path, "rb") as f:
            while True:
                hdr = f.read(9)
                if len(hdr) < 9:
                    break
                op, plen, mlen = struct.unpack("<BII", hdr)
                raw_path = f.read(plen)
                meta = f.read(mlen)
                if len(raw_path) < plen or len(meta) < mlen:
                    break  # torn tail record; recover what we have
                try:
                    path = raw_path.decode()
                except UnicodeDecodeError:
                    break  # torn mid-character: same recovery as short read
                if op == self._PUT:
                    self._mem.insert_entry(Entry.decode(path, meta))
                else:
                    self._mem.delete_entry(path)

    def _append(self, op: int, path: str, meta: bytes) -> None:
        p = path.encode()
        with self._lock:
            self._f.write(struct.pack("<BII", op, len(p), len(meta)) + p + meta)
            self._f.flush()

    def insert_entry(self, entry: Entry) -> None:
        self._mem.insert_entry(entry)
        self._append(self._PUT, entry.full_path, entry.encode())

    update_entry = insert_entry

    def find_entry(self, full_path: str) -> Entry:
        return self._mem.find_entry(full_path)

    def delete_entry(self, full_path: str) -> None:
        self._mem.delete_entry(full_path)
        self._append(self._DEL, full_path, b"")

    def list_directory_entries(self, *args, **kw):
        return self._mem.list_directory_entries(*args, **kw)

    def close(self) -> None:
        self._f.close()


def new_store(kind: str, path: str = "") -> FilerStore:
    if kind == "memory":
        return MemoryStore()
    if kind == "sqlite":
        return SqliteStore(path or ":memory:")
    if kind == "sql":
        # the abstract_sql dialect layer over stdlib sqlite3
        # (filer2/abstract_sql/abstract_sql_store.go role)
        from seaweedfs_tpu_torch.filer.abstract_sql import new_sqlite_sql_store

        return new_sqlite_sql_store(path or ":memory:")
    if kind in ("mysql", "postgres"):
        from seaweedfs_tpu_torch.filer.abstract_sql import new_gated_sql_store

        return new_gated_sql_store(kind, path)
    if kind == "redis":
        # real RESP-protocol store, gated on connectivity
        from seaweedfs_tpu_torch.filer.redis_store import RedisStore

        return RedisStore(path or "localhost:6379")
    if kind == "cassandra":
        # real CQL-v4-protocol store, gated on connectivity
        from seaweedfs_tpu_torch.filer.cassandra_store import CassandraStore

        return CassandraStore(path or "localhost:9042")
    if kind == "etcd":
        # etcd v3 gateway REST store, gated on connectivity
        from seaweedfs_tpu_torch.filer.etcd_store import EtcdFilerStore

        return EtcdFilerStore(path or "localhost:2379")
    if kind == "tikv":
        # raw-KV gRPC store via PD routing, gated on connectivity
        from seaweedfs_tpu_torch.filer.tikv_store import TikvStore

        return TikvStore(path or "localhost:2379")
    if kind == "sortedlog":
        if not path:
            raise ValueError("sortedlog store needs a path")
        return SortedLogStore(path)
    if kind == "lsm":
        if not path:
            raise ValueError("lsm store needs a directory path")
        from seaweedfs_tpu_torch.filer.lsm import LsmStore

        return LsmStore(path)
    raise ValueError(
        f"unknown filer store {kind!r}: embedded kinds are memory | sqlite"
        " | sql | sortedlog | lsm; redis (RESP), cassandra (CQL v4), etcd (v3"
        " gateway REST), tikv (raw-KV gRPC via PD), mysql and postgres"
        " (their own wire protocols) all speak to a live server"
        " (path = 'host:port' / PD address / DSN)"
    )
