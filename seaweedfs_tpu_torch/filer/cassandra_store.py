"""Cassandra-backed filer store speaking the CQL v4 binary protocol.

Behavioral match of weed/filer2/cassandra/cassandra_store.go: the
`filemeta (directory, name, meta)` table with `PRIMARY KEY (directory,
name)` clustering ASC, and its five statements verbatim —

  INSERT INTO filemeta (directory,name,meta) VALUES(?,?,?) USING TTL ?
  SELECT meta FROM filemeta WHERE directory=? AND name=?
  DELETE FROM filemeta WHERE directory=? AND name=?
  DELETE FROM filemeta WHERE directory=?
  SELECT name, meta FROM filemeta WHERE directory=? AND name>[=]?
      ORDER BY name ASC LIMIT ?

The reference rides gocql; this store implements the wire protocol
over one socket (native_protocol_v4: STARTUP/READY handshake, QUERY
with bound values at consistency ONE, RESULT void/rows decoding,
ERROR surfacing). The gate is connectivity — constructing dials the
node and raises with guidance; tests/cloud_fakes.FakeCassandra speaks
the same frames offline.

The port of seaweedfs_tpu/filer/cassandra_store.py.
"""

from __future__ import annotations

import socket
import struct
import threading

from seaweedfs_tpu_torch.filer.entry import Entry, child_path, normalize_path, split_path
from seaweedfs_tpu_torch.filer.filerstore import EntryNotFound, FilerStore

# opcodes (native_protocol_v4.spec §2.4)
OP_ERROR, OP_STARTUP, OP_READY, OP_QUERY, OP_RESULT = 0x00, 0x01, 0x02, 0x07, 0x08
RESULT_VOID, RESULT_ROWS, RESULT_SET_KEYSPACE = 0x0001, 0x0002, 0x0003
CONSISTENCY_ONE = 0x0001
FLAG_VALUES = 0x01
GLOBAL_TABLES_SPEC = 0x0001


def _string(s: str) -> bytes:
    b = s.encode()
    return struct.pack(">H", len(b)) + b


def _long_string(s: str) -> bytes:
    b = s.encode()
    return struct.pack(">i", len(b)) + b


def _value(b: bytes | None) -> bytes:
    if b is None:
        return struct.pack(">i", -1)
    return struct.pack(">i", len(b)) + b


class _FrameReader:
    def __init__(self, data: bytes):
        self.data = data
        self.off = 0

    def take(self, n: int) -> bytes:
        d = self.data[self.off : self.off + n]
        if len(d) < n:
            raise ValueError("cql: short frame")
        self.off += n
        return d

    def i16(self) -> int:
        return struct.unpack(">h", self.take(2))[0]

    def i32(self) -> int:
        return struct.unpack(">i", self.take(4))[0]

    def string(self) -> str:
        return self.take(struct.unpack(">H", self.take(2))[0]).decode()

    def value(self) -> bytes | None:
        n = self.i32()
        return None if n < 0 else self.take(n)

    def type_option(self) -> None:
        """Consume one column type option (simple ids only; our schema
        is varchar/blob)."""
        tid = self.i16()
        if tid == 0x0000:  # custom: class string
            self.string()
        elif tid in (0x0020, 0x0022):  # list/set: one sub-option
            self.type_option()
        elif tid == 0x0021:  # map: two sub-options
            self.type_option()
            self.type_option()


class CqlConnection:
    """One node connection: framed request/response, stream id 0."""

    def __init__(self, host: str, port: int, timeout: float = 10.0):
        self.sock = socket.create_connection((host, port), timeout=timeout)
        self.sock.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, True)
        self.rfile = self.sock.makefile("rb")
        self._lock = threading.Lock()
        # STARTUP → READY (v4 handshake)
        body = struct.pack(">H", 1) + _string("CQL_VERSION") + _string("3.0.0")
        opcode, resp = self.request(OP_STARTUP, body)
        if opcode != OP_READY:
            raise ConnectionError(f"cql: handshake failed (opcode {opcode})")

    def close(self) -> None:
        for c in (self.rfile.close, self.sock.close):
            try:
                c()
            except OSError:
                pass

    def request(self, opcode: int, body: bytes) -> tuple[int, bytes]:
        with self._lock:
            frame = struct.pack(">BBhBi", 0x04, 0, 0, opcode, len(body)) + body
            self.sock.sendall(frame)
            hdr = self.rfile.read(9)
            if len(hdr) < 9:
                raise ConnectionError("cql: connection closed")
            _ver, _flags, _stream, r_opcode, length = struct.unpack(">BBhBi", hdr)
            payload = self.rfile.read(length)
            if len(payload) < length:
                raise ConnectionError("cql: short frame body")
        return r_opcode, payload

    def query(self, cql: str, values: list[bytes | None] = ()):  # type: ignore[assignment]
        """Run one QUERY; returns list[list[bytes|None]] for rows
        results, [] for void."""
        body = _long_string(cql) + struct.pack(">H", CONSISTENCY_ONE)
        if values:
            body += struct.pack(">BH", FLAG_VALUES, len(values))
            for v in values:
                body += _value(v)
        else:
            body += struct.pack(">B", 0)
        opcode, payload = self.request(OP_QUERY, body)
        if opcode == OP_ERROR:
            r = _FrameReader(payload)
            code = r.i32()
            raise RuntimeError(f"cql error {code:#06x}: {r.string()}")
        if opcode != OP_RESULT:
            raise ValueError(f"cql: unexpected opcode {opcode}")
        r = _FrameReader(payload)
        kind = r.i32()
        if kind in (RESULT_VOID, RESULT_SET_KEYSPACE):
            return []
        if kind != RESULT_ROWS:
            return []
        flags = r.i32()
        columns = r.i32()
        if flags & GLOBAL_TABLES_SPEC:
            r.string(), r.string()  # keyspace, table
        for _ in range(columns):
            if not flags & GLOBAL_TABLES_SPEC:
                r.string(), r.string()
            r.string()  # column name
            r.type_option()
        rows = []
        for _ in range(r.i32()):
            rows.append([r.value() for _ in range(columns)])
        return rows


class CassandraStore(FilerStore):
    name = "cassandra"

    def __init__(self, hosts: str, keyspace: str = "seaweedfs"):
        host, _, port = hosts.split(",")[0].strip().partition(":")
        try:
            self._conn = CqlConnection(host, int(port or 9042))
        except OSError as e:
            raise RuntimeError(
                f"filer store 'cassandra' cannot reach a node at {hosts!r} "
                f"({e}); start one, or use an embedded kind: memory | "
                "sqlite | sql | sortedlog | lsm"
            ) from e
        try:
            self._conn.query(f"USE {keyspace}")
        except (RuntimeError, OSError) as e:
            self._conn.close()  # don't leak the TCP connection
            raise RuntimeError(
                f"filer store 'cassandra': keyspace {keyspace!r} not usable "
                f"on {hosts!r} ({e}); create it with the filemeta table "
                "(CREATE TABLE filemeta (directory varchar, name varchar, "
                "meta blob, PRIMARY KEY (directory, name)) WITH CLUSTERING "
                "ORDER BY (name ASC)), or use an embedded kind"
            ) from e

    def insert_entry(self, entry: Entry) -> None:
        d, name = split_path(entry.full_path)
        # Bind the entry's TTL (reference cassandra_store.go:63 binds
        # entry.TtlSec) so TTL'd entries expire server-side.
        ttl = entry.attr.ttl_sec
        self._conn.query(
            "INSERT INTO filemeta (directory,name,meta) VALUES(?,?,?) "
            "USING TTL ? ",
            [d.encode(), name.encode(), entry.encode(), struct.pack(">i", ttl)],
        )

    update_entry = insert_entry

    def find_entry(self, full_path: str) -> Entry:
        d, name = split_path(full_path)
        rows = self._conn.query(
            "SELECT meta FROM filemeta WHERE directory=? AND name=?",
            [d.encode(), name.encode()],
        )
        if not rows or rows[0][0] is None:
            raise EntryNotFound(full_path)
        return Entry.decode(full_path, rows[0][0])

    def delete_entry(self, full_path: str) -> None:
        d, name = split_path(full_path)
        self._conn.query(
            "DELETE FROM filemeta WHERE directory=? AND name=?",
            [d.encode(), name.encode()],
        )

    def delete_folder_children(self, full_path: str) -> None:
        d = normalize_path(full_path)
        self._conn.query(
            "DELETE FROM filemeta WHERE directory=?", [d.encode()]
        )

    def list_directory_entries(
        self, dir_path, start_file_name, include_start, limit
    ):
        d = normalize_path(dir_path)
        op = ">=" if include_start else ">"
        rows = self._conn.query(
            f"SELECT name, meta FROM filemeta WHERE directory=? AND name{op}? "
            "ORDER BY name ASC LIMIT ?",
            [
                d.encode(),
                start_file_name.encode(),
                struct.pack(">i", limit),
            ],
        )
        out = []
        for name_b, meta in rows:
            if name_b is None or meta is None:
                continue
            name = name_b.decode()
            out.append(Entry.decode(child_path(d, name), meta))
        return out

    def close(self) -> None:
        self._conn.close()
