"""Minimal PostgreSQL driver: frontend/backend protocol v3, no library.

Just enough DB-API surface for filer/abstract_sql.AbstractSqlStore —
connection.cursor()/commit()/rollback()/close(), cursor.execute() with
$N parameters, fetchone/fetchall — speaking the wire protocol directly:

  * StartupMessage (protocol 3.0) with cleartext or md5 password auth
  * the EXTENDED query protocol for parameterized statements
    (Parse → Bind with binary parameter/result formats → Describe →
    Execute → Sync), so values never pass through SQL literals
  * simple Query for BEGIN/COMMIT/ROLLBACK (DB-API transaction shape:
    implicit BEGIN before the first statement, explicit commit/rollback)

Parameter and result values use the binary format: int → int8
big-endian, str → utf8, bytes → raw. That covers the filemeta schema
(dirhash BIGINT, name/directory VARCHAR, meta bytea). Unique-violation
errors (SQLSTATE 23505) raise IntegrityError so the store's
duplicate-key detection works per PEP 249. The offline peer is
tests/cloud_fakes.FakePostgres, which speaks the same frames.

The port of seaweedfs_tpu/filer/pg_driver.py.
"""

from __future__ import annotations

import hashlib
import socket
import struct
import threading


class PgError(RuntimeError):
    def __init__(self, fields: dict):
        self.sqlstate = fields.get("C", "")
        super().__init__(
            f"postgres error {self.sqlstate}: {fields.get('M', '')}"
        )


class IntegrityError(PgError):
    """SQLSTATE class 23 (integrity constraint violation)."""


def _cstr(s: str) -> bytes:
    return s.encode() + b"\0"


class PgConnection:
    def __init__(
        self,
        host: str,
        port: int = 5432,
        user: str = "seaweedfs",
        password: str = "",
        database: str = "seaweedfs",
        timeout: float = 10.0,
    ):
        self.sock = socket.create_connection((host, port), timeout=timeout)
        self.sock.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, True)
        self.rfile = self.sock.makefile("rb")
        self._lock = threading.RLock()
        self._in_txn = False
        try:
            body = struct.pack(">i", 196608)  # protocol 3.0
            body += _cstr("user") + _cstr(user)
            body += _cstr("database") + _cstr(database)
            body += b"\0"
            self.sock.sendall(struct.pack(">i", len(body) + 4) + body)
            self._auth(user, password)
        except BaseException:
            self.close()  # don't leak the fd on a failed handshake/auth
            raise

    # --- frames ---------------------------------------------------------
    def _send(self, kind: bytes, body: bytes) -> None:
        self.sock.sendall(kind + struct.pack(">i", len(body) + 4) + body)

    def _recv(self) -> tuple[bytes, bytes]:
        kind = self.rfile.read(1)
        if not kind:
            raise ConnectionError("postgres: connection closed")
        (length,) = struct.unpack(">i", self.rfile.read(4))
        return kind, self.rfile.read(length - 4)

    @staticmethod
    def _error_fields(body: bytes) -> dict:
        fields = {}
        for part in body.split(b"\0"):
            if part:
                fields[chr(part[0])] = part[1:].decode("utf-8", "replace")
        return fields

    def _raise(self, body: bytes) -> None:
        fields = self._error_fields(body)
        cls = (
            IntegrityError
            if fields.get("C", "").startswith("23")
            else PgError
        )
        raise cls(fields)

    def _auth(self, user: str, password: str) -> None:
        while True:
            kind, body = self._recv()
            if kind == b"E":
                self._raise(body)
            if kind == b"R":
                (code,) = struct.unpack(">i", body[:4])
                if code == 0:
                    continue  # AuthenticationOk
                if code == 3:  # cleartext
                    self._send(b"p", _cstr(password))
                elif code == 5:  # md5
                    salt = body[4:8]
                    inner = hashlib.md5(
                        password.encode() + user.encode()
                    ).hexdigest()
                    digest = hashlib.md5(inner.encode() + salt).hexdigest()
                    self._send(b"p", _cstr("md5" + digest))
                else:
                    raise ConnectionError(
                        f"postgres: unsupported auth method {code}"
                    )
                continue
            if kind == b"Z":  # ReadyForQuery
                return
            # ParameterStatus / BackendKeyData / NoticeResponse: skip

    # --- queries --------------------------------------------------------
    @staticmethod
    def _encode_param(v) -> bytes | None:
        if v is None:
            return None
        if isinstance(v, bytes):
            return v
        if isinstance(v, int):
            return struct.pack(">q", v)
        return str(v).encode()

    def _simple(self, sql: str) -> None:
        with self._lock:
            self._send(b"Q", _cstr(sql))
            err = None
            while True:
                kind, body = self._recv()
                if kind == b"E":
                    err = body
                elif kind == b"Z":
                    break
            if err is not None:
                self._raise(err)

    @staticmethod
    def _frame(kind: bytes, body: bytes) -> bytes:
        return kind + struct.pack(">i", len(body) + 4) + body

    def execute(self, sql: str, args: tuple = ()):  # -> list[list]
        """Extended-protocol statement; returns data rows (raw bytes
        per column, None for NULL).

        Outside an explicit transaction the statement runs standalone
        (already atomic in PostgreSQL — no BEGIN/COMMIT round trips).
        Inside one, a same-named SAVEPOINT precedes it so a failed
        statement (e.g. a duplicate-key INSERT the store degrades to
        UPDATE) rolls back to the savepoint instead of aborting the
        whole transaction and wedging the connection. All frames for
        the statement go out in ONE write."""
        with self._lock:
            def bare(stmt_sql: str) -> bytes:
                # Parse/Bind/Execute for a no-param, no-result utility
                # statement; Bind = unnamed portal + stmt + 3 zero
                # int16 counts (formats, params, result formats)
                out = self._frame(
                    b"P", b"\0" + _cstr(stmt_sql) + struct.pack(">h", 0)
                )
                out += self._frame(
                    b"B", b"\0\0" + struct.pack(">hhh", 0, 0, 0)
                )
                out += self._frame(b"E", b"\0" + struct.pack(">i", 0))
                return out

            buf = bytearray()
            if self._in_txn:
                buf += bare("SAVEPOINT _sw")
            buf += self._frame(
                b"P", b"\0" + _cstr(sql) + struct.pack(">h", 0)
            )
            bind = b"\0\0"  # unnamed portal, unnamed statement
            bind += struct.pack(">hh", 1, 1)  # all params binary
            bind += struct.pack(">h", len(args))
            for a in args:
                enc = self._encode_param(a)
                if enc is None:
                    bind += struct.pack(">i", -1)
                else:
                    bind += struct.pack(">i", len(enc)) + enc
            bind += struct.pack(">hh", 1, 1)  # all results binary
            buf += self._frame(b"B", bind)
            buf += self._frame(b"E", b"\0" + struct.pack(">i", 0))
            if self._in_txn:
                # pg skips messages after an error until Sync, so this
                # RELEASE runs only when the statement succeeded —
                # savepoints never pile up on the happy path
                buf += bare("RELEASE SAVEPOINT _sw")
            buf += self._frame(b"S", b"")
            self.sock.sendall(bytes(buf))
            rows: list[list] = []
            err = None
            while True:
                kind, body = self._recv()
                if kind == b"E":
                    err = body
                elif kind == b"D":
                    (ncols,) = struct.unpack(">h", body[:2])
                    off = 2
                    row = []
                    for _ in range(ncols):
                        (n,) = struct.unpack(">i", body[off : off + 4])
                        off += 4
                        if n < 0:
                            row.append(None)
                        else:
                            row.append(body[off : off + n])
                            off += n
                    rows.append(row)
                elif kind == b"Z":
                    break
            if err is not None:
                if self._in_txn:
                    # restore the transaction to the savepoint so the
                    # caller can continue (insert→update degrade), then
                    # drop the savepoint so error paths don't pile them
                    # up either
                    self._simple("ROLLBACK TO SAVEPOINT _sw")
                    self._simple("RELEASE SAVEPOINT _sw")
                self._raise(err)
            return rows

    # --- DB-API-ish surface ---------------------------------------------
    def cursor(self) -> "PgCursor":
        return PgCursor(self)

    def begin(self) -> None:
        """Open an explicit transaction (AbstractSqlStore calls this
        from begin_transaction when the driver offers it)."""
        with self._lock:
            if not self._in_txn:
                self._simple("BEGIN")
                self._in_txn = True

    def commit(self) -> None:
        with self._lock:
            if self._in_txn:
                self._simple("COMMIT")
                self._in_txn = False

    def rollback(self) -> None:
        with self._lock:
            if self._in_txn:
                self._simple("ROLLBACK")
                self._in_txn = False

    def close(self) -> None:
        for c in (self.rfile.close, self.sock.close):
            try:
                c()
            except OSError:
                pass


class PgCursor:
    def __init__(self, conn: PgConnection):
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
