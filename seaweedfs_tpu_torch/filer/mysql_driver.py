"""Minimal MySQL driver: client/server protocol, no library.

Just enough DB-API surface for filer/abstract_sql.AbstractSqlStore,
speaking the MySQL client/server protocol directly:

  * handshake v10 with mysql_native_password auth
    (token = SHA1(pw) XOR SHA1(scramble + SHA1(SHA1(pw))))
  * prepared statements (COM_STMT_PREPARE / COM_STMT_EXECUTE) with
    binary parameter and result rows, so values never ride SQL text;
    the dialect's %s placeholders are rewritten to the protocol's `?`
  * COM_QUERY for BEGIN / COMMIT / ROLLBACK / DDL

Parameters: int → LONGLONG, str → VAR_STRING, bytes → BLOB. Result
decoding follows each column's declared type (LONGLONG binary, else
length-encoded bytes). ER_DUP_ENTRY (1062) and friends raise
IntegrityError per PEP 249 so the store's duplicate-key detection
works. MySQL does not abort a transaction on a statement error, so no
savepoint dance is needed (unlike pg_driver). The offline peer is
tests/cloud_fakes.FakeMysql.

The port of seaweedfs_tpu/filer/mysql_driver.py.
"""

from __future__ import annotations

import hashlib
import socket
import struct
import threading

CLIENT_LONG_PASSWORD = 0x00000001
CLIENT_PROTOCOL_41 = 0x00000200
CLIENT_CONNECT_WITH_DB = 0x00000008
CLIENT_SECURE_CONNECTION = 0x00008000
CLIENT_PLUGIN_AUTH = 0x00080000

COM_QUERY, COM_STMT_PREPARE, COM_STMT_EXECUTE, COM_STMT_CLOSE = (
    0x03,
    0x16,
    0x17,
    0x19,
)

TYPE_LONGLONG, TYPE_BLOB, TYPE_VAR_STRING = 0x08, 0xFC, 0xFD

_DUP_ERRNOS = {1062, 1557, 1569, 1586}  # duplicate key/entry family


class MysqlError(RuntimeError):
    def __init__(self, errno: int, message: str):
        self.errno = errno
        super().__init__(f"mysql error {errno}: {message}")


class IntegrityError(MysqlError):
    pass


def _scramble_native(password: str, salt: bytes) -> bytes:
    if not password:
        return b""
    h1 = hashlib.sha1(password.encode()).digest()
    h2 = hashlib.sha1(h1).digest()
    h3 = hashlib.sha1(salt + h2).digest()
    return bytes(a ^ b for a, b in zip(h1, h3))


def _lenenc(n: int) -> bytes:
    if n < 0xFB:
        return bytes([n])
    if n < 1 << 16:
        return b"\xfc" + struct.pack("<H", n)
    if n < 1 << 24:
        return b"\xfd" + struct.pack("<I", n)[:3]
    return b"\xfe" + struct.pack("<Q", n)


class _Reader:
    def __init__(self, data: bytes):
        self.data = data
        self.off = 0

    def take(self, n: int) -> bytes:
        d = self.data[self.off : self.off + n]
        self.off += n
        return d

    def u8(self) -> int:
        return self.take(1)[0]

    def u16(self) -> int:
        return struct.unpack("<H", self.take(2))[0]

    def u32(self) -> int:
        return struct.unpack("<I", self.take(4))[0]

    def lenenc_int(self) -> int:
        first = self.u8()
        if first < 0xFB:
            return first
        if first == 0xFC:
            return self.u16()
        if first == 0xFD:
            return int.from_bytes(self.take(3), "little")
        return struct.unpack("<Q", self.take(8))[0]

    def lenenc_bytes(self) -> bytes:
        return self.take(self.lenenc_int())

    def cstr(self) -> bytes:
        end = self.data.index(0, self.off)
        out = self.data[self.off : end]
        self.off = end + 1
        return out


class MysqlConnection:
    def __init__(
        self,
        host: str,
        port: int = 3306,
        user: str = "seaweedfs",
        password: str = "",
        database: str = "seaweedfs",
        timeout: float = 10.0,
    ):
        self.sock = socket.create_connection((host, port), timeout=timeout)
        self.sock.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, True)
        self.rfile = self.sock.makefile("rb")
        self._lock = threading.RLock()
        self._seq = 0
        self._in_txn = False
        self._stmt_cache: dict[str, int] = {}  # sql -> server stmt id
        try:
            self._handshake(user, password, database)
        except BaseException:
            self.close()
            raise

    # --- packet framing -------------------------------------------------
    # A payload length of 0xFFFFFF marks a continuation: the logical packet
    # carries on in the next frame (and a payload of exactly 16 MiB - 1 must
    # be followed by an empty terminator frame on send).
    _MAX_FRAME = 0xFFFFFF

    def _read_packet(self) -> bytes:
        chunks = []
        while True:
            hdr = self.rfile.read(4)
            if len(hdr) < 4:
                raise ConnectionError("mysql: connection closed")
            length = int.from_bytes(hdr[:3], "little")
            self._seq = hdr[3] + 1
            payload = self.rfile.read(length)
            if len(payload) < length:
                raise ConnectionError("mysql: short packet")
            chunks.append(payload)
            if length < self._MAX_FRAME:
                return b"".join(chunks) if len(chunks) > 1 else chunks[0]

    def _send_packet(self, payload: bytes, reset_seq: bool = False) -> None:
        if reset_seq:
            self._seq = 0
        if len(payload) < self._MAX_FRAME:  # common case: one frame, one send
            self.sock.sendall(
                len(payload).to_bytes(3, "little")
                + bytes([self._seq & 0xFF])
                + payload
            )
            self._seq += 1
            return
        view = memoryview(payload)
        off = 0
        while True:
            frame = view[off : off + self._MAX_FRAME]
            self.sock.sendall(
                len(frame).to_bytes(3, "little") + bytes([self._seq & 0xFF])
            )
            if frame:
                self.sock.sendall(frame)
            self._seq += 1
            off += len(frame)
            # A max-size frame always needs a follow-up (possibly empty).
            if len(frame) < self._MAX_FRAME:
                break

    def _raise_err(self, payload: bytes) -> None:
        r = _Reader(payload)
        r.u8()  # 0xff
        errno = r.u16()
        rest = r.data[r.off :]
        if rest.startswith(b"#"):
            rest = rest[6:]  # sql state marker
        msg = rest.decode("utf-8", "replace")
        cls = IntegrityError if errno in _DUP_ERRNOS else MysqlError
        raise cls(errno, msg)

    # --- handshake ------------------------------------------------------
    def _handshake(self, user: str, password: str, database: str) -> None:
        greeting = self._read_packet()
        r = _Reader(greeting)
        if r.u8() == 0xFF:
            self._raise_err(greeting)
        r.cstr()  # server version
        r.u32()  # thread id
        salt = r.take(8)
        r.u8()  # filler
        r.u16()  # cap low
        r.u8()  # charset
        r.u16()  # status
        r.u16()  # cap high
        auth_len = r.u8()
        r.take(10)  # reserved
        salt += r.take(max(13, auth_len - 8))[:12]
        caps = (
            CLIENT_LONG_PASSWORD
            | CLIENT_PROTOCOL_41
            | CLIENT_SECURE_CONNECTION
            | CLIENT_CONNECT_WITH_DB
            | CLIENT_PLUGIN_AUTH
        )
        token = _scramble_native(password, salt)
        resp = struct.pack("<IIB23x", caps, 1 << 24, 0x21)
        resp += user.encode() + b"\0"
        resp += bytes([len(token)]) + token
        resp += database.encode() + b"\0"
        resp += b"mysql_native_password\0"
        self._send_packet(resp)
        ok = self._read_packet()
        if ok and ok[0] == 0xFF:
            self._raise_err(ok)
        if ok and ok[0] == 0xFE:
            raise ConnectionError(
                "mysql: server requests an auth switch (caching_sha2?); "
                "create the user WITH mysql_native_password"
            )
        # 0x00 OK

    # --- queries --------------------------------------------------------
    def _query_ok(self, sql: str) -> None:
        with self._lock:
            self._send_packet(bytes([COM_QUERY]) + sql.encode(), reset_seq=True)
            resp = self._read_packet()
            if resp and resp[0] == 0xFF:
                self._raise_err(resp)

    @staticmethod
    def _param(v):
        if isinstance(v, bool):
            v = int(v)
        if v is None:
            return TYPE_VAR_STRING, None
        if isinstance(v, int):
            return TYPE_LONGLONG, struct.pack("<q", v)
        if isinstance(v, bytes):
            return TYPE_BLOB, _lenenc(len(v)) + v
        b = str(v).encode()
        return TYPE_VAR_STRING, _lenenc(len(b)) + b

    def _prepare(self, sql: str) -> int:
        """COM_STMT_PREPARE once per distinct SQL: the seven dialect
        statements are a fixed set, so every later execute skips the
        prepare round trip (and nothing leaks — cached handles close
        with the connection)."""
        cached = self._stmt_cache.get(sql)
        if cached is not None:
            return cached
        self._send_packet(
            bytes([COM_STMT_PREPARE]) + sql.encode(), reset_seq=True
        )
        resp = self._read_packet()
        if resp[0] == 0xFF:
            self._raise_err(resp)
        r = _Reader(resp)
        r.u8()  # 0x00
        stmt_id = r.u32()
        num_cols = r.u16()
        num_params = r.u16()
        for _ in range(num_params):
            self._read_packet()  # param definition
        if num_params:
            self._read_packet()  # EOF
        for _ in range(num_cols):
            self._read_packet()  # column definition (re-sent at execute)
        if num_cols:
            self._read_packet()  # EOF
        self._stmt_cache[sql] = stmt_id
        return stmt_id

    def execute(self, sql: str, args: tuple = ()):  # -> list[list]
        """Prepare (cached) + execute (binary protocol); returns rows."""
        sql = sql.replace("%s", "?")  # dialect paramstyle → protocol's
        with self._lock:
            stmt_id = self._prepare(sql)
            body = bytes([COM_STMT_EXECUTE]) + struct.pack(
                "<IBI", stmt_id, 0, 1
            )
            nbytes = (len(args) + 7) // 8
            null_bitmap = bytearray(nbytes)
            types = b""
            values = b""
            for i, a in enumerate(args):
                t, enc = self._param(a)
                types += struct.pack("<BB", t, 0)
                if enc is None:
                    null_bitmap[i // 8] |= 1 << (i % 8)
                else:
                    values += enc
            body += bytes(null_bitmap) + b"\x01" + types + values
            self._send_packet(body, reset_seq=True)
            return self._read_resultset()

    @staticmethod
    def _column_type(definition: bytes) -> int:
        r = _Reader(definition)
        for _ in range(6):  # catalog schema table org_table name org_name
            r.lenenc_bytes()
        r.lenenc_int()  # fixed-length fields marker (0x0c)
        r.u16()  # charset
        r.u32()  # column length
        return r.u8()

    def _read_resultset(self):
        first = self._read_packet()
        if first[0] == 0xFF:
            self._raise_err(first)
        if first[0] == 0x00:  # OK: no resultset
            return []
        r = _Reader(first)
        ncols = r.lenenc_int()
        col_types = []
        for _ in range(ncols):
            col_types.append(self._column_type(self._read_packet()))
        self._read_packet()  # EOF
        rows = []
        while True:
            pkt = self._read_packet()
            if pkt[0] == 0xFE and len(pkt) < 9:  # EOF
                return rows
            if pkt[0] == 0xFF:
                self._raise_err(pkt)
            rr = _Reader(pkt)
            rr.u8()  # 0x00 row header
            null_bitmap = rr.take((ncols + 9) // 8)
            row = []
            for i, t in enumerate(col_types):
                if null_bitmap[(i + 2) // 8] & (1 << ((i + 2) % 8)):
                    row.append(None)
                elif t == TYPE_LONGLONG:
                    row.append(struct.unpack("<q", rr.take(8))[0])
                else:
                    row.append(rr.lenenc_bytes())
            rows.append(row)

    # --- DB-API-ish surface ---------------------------------------------
    def cursor(self) -> "MysqlCursor":
        return MysqlCursor(self)

    def begin(self) -> None:
        if not self._in_txn:
            self._query_ok("BEGIN")
            self._in_txn = True

    def commit(self) -> None:
        # autocommit covers standalone statements; only a begin()'d
        # transaction needs an explicit COMMIT round trip
        if self._in_txn:
            self._query_ok("COMMIT")
            self._in_txn = False

    def rollback(self) -> None:
        if self._in_txn:
            self._query_ok("ROLLBACK")
            self._in_txn = False

    def close(self) -> None:
        # best-effort: release cached server-side statement handles
        try:
            with self._lock:
                for stmt_id in self._stmt_cache.values():
                    self._send_packet(
                        bytes([COM_STMT_CLOSE]) + struct.pack("<I", stmt_id),
                        reset_seq=True,
                    )
                self._stmt_cache.clear()
        except OSError:
            pass
        for c in (self.rfile.close, self.sock.close):
            try:
                c()
            except OSError:
                pass


class MysqlCursor:
    def __init__(self, conn: MysqlConnection):
        self._conn = conn
        self._rows: list[list] = []

    def execute(self, sql: str, args: tuple = ()) -> None:
        self._rows = self._conn.execute(sql, tuple(args))

    def fetchone(self):
        return self._rows[0] if self._rows else None

    def fetchall(self):
        return self._rows

    def close(self) -> None:
        self._rows = []
