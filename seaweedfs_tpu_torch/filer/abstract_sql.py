"""Dialect-driven SQL filer store — the abstract_sql layer.

Behavioral match of weed/filer2/abstract_sql/abstract_sql_store.go:13-47:
one store implementation holds the seven SQL statements as data; each
dialect (mysql_store.go:45-52, postgres_store.go:47-54, and sqlite as
the in-image driver) contributes only its SQL text and a DB-API
connection factory. The schema is the reference's `filemeta` table —
(dirhash, name, directory, meta) with dirhash the md5-folded int64 of
the directory string (util/bytes.go:53 HashStringToLong) so the
B-tree clusters siblings and list queries stay range scans.

mysql / postgres construct with their reference SQL but gate on their
client libraries, which are not in this image — new_store("mysql"|
"postgres") raises with guidance; the `sql` kind runs the SAME dialect machinery over
stdlib sqlite3 and is what the conformance matrix exercises.

The port of seaweedfs_tpu/filer/abstract_sql.py.
"""

from __future__ import annotations

import hashlib
import threading
from dataclasses import dataclass

from seaweedfs_tpu_torch.filer.entry import Entry, child_path, normalize_path, split_path
from seaweedfs_tpu_torch.filer.filerstore import EntryNotFound, FilerStore


def hash_string_to_long(directory: str) -> int:
    """Reference-compatible dirhash (util/bytes.go:53): the first 8 md5
    bytes folded big-endian into a signed int64."""
    digest = hashlib.md5(directory.encode()).digest()
    return int.from_bytes(digest[:8], "big", signed=True)


@dataclass(frozen=True)
class SqlDialect:
    """The seven statements of abstract_sql_store.go:15-21 plus DDL.

    Parameter order is the reference's:
      insert  (dirhash, name, directory, meta)
      update  (meta, dirhash, name, directory)
      find    (dirhash, name, directory)
      delete  (dirhash, name, directory)
      delete_folder_children (dirhash, directory)
      list_*  (dirhash, start_name, directory, limit)
    """

    name: str
    create_table: str
    insert: str
    update: str
    find: str
    delete: str
    delete_folder_children: str
    list_exclusive: str
    list_inclusive: str


SQLITE_DIALECT = SqlDialect(
    name="sqlite",
    create_table=(
        "CREATE TABLE IF NOT EXISTS filemeta ("
        " dirhash INTEGER,"
        " name TEXT,"
        " directory TEXT,"
        " meta BLOB,"
        " PRIMARY KEY (dirhash, name))"
    ),
    insert="INSERT INTO filemeta (dirhash,name,directory,meta) VALUES(?,?,?,?)",
    update="UPDATE filemeta SET meta=? WHERE dirhash=? AND name=? AND directory=?",
    find="SELECT meta FROM filemeta WHERE dirhash=? AND name=? AND directory=?",
    delete="DELETE FROM filemeta WHERE dirhash=? AND name=? AND directory=?",
    delete_folder_children="DELETE FROM filemeta WHERE dirhash=? AND directory=?",
    list_exclusive=(
        "SELECT name, meta FROM filemeta WHERE dirhash=? AND name>? AND"
        " directory=? ORDER BY name ASC LIMIT ?"
    ),
    list_inclusive=(
        "SELECT name, meta FROM filemeta WHERE dirhash=? AND name>=? AND"
        " directory=? ORDER BY name ASC LIMIT ?"
    ),
)

# mysql_store.go:45-52 verbatim SQL shapes (%s paramstyle)
MYSQL_DIALECT = SqlDialect(
    name="mysql",
    create_table=(
        "CREATE TABLE IF NOT EXISTS filemeta ("
        " dirhash BIGINT,"
        " name VARCHAR(1000),"
        " directory TEXT,"
        " meta LONGBLOB,"
        " PRIMARY KEY (dirhash, name))"
    ),
    insert="INSERT INTO filemeta (dirhash,name,directory,meta) VALUES(%s,%s,%s,%s)",
    update="UPDATE filemeta SET meta=%s WHERE dirhash=%s AND name=%s AND directory=%s",
    find="SELECT meta FROM filemeta WHERE dirhash=%s AND name=%s AND directory=%s",
    delete="DELETE FROM filemeta WHERE dirhash=%s AND name=%s AND directory=%s",
    delete_folder_children="DELETE FROM filemeta WHERE dirhash=%s AND directory=%s",
    list_exclusive=(
        "SELECT name, meta FROM filemeta WHERE dirhash=%s AND name>%s AND"
        " directory=%s ORDER BY name ASC LIMIT %s"
    ),
    list_inclusive=(
        "SELECT name, meta FROM filemeta WHERE dirhash=%s AND name>=%s AND"
        " directory=%s ORDER BY name ASC LIMIT %s"
    ),
)

# postgres_store.go:47-54 verbatim SQL shapes ($N paramstyle)
POSTGRES_DIALECT = SqlDialect(
    name="postgres",
    create_table=(
        "CREATE TABLE IF NOT EXISTS filemeta ("
        " dirhash BIGINT,"
        " name VARCHAR(1000),"
        " directory VARCHAR(4096),"
        " meta bytea,"
        " PRIMARY KEY (dirhash, name))"
    ),
    insert="INSERT INTO filemeta (dirhash,name,directory,meta) VALUES($1,$2,$3,$4)",
    update="UPDATE filemeta SET meta=$1 WHERE dirhash=$2 AND name=$3 AND directory=$4",
    find="SELECT meta FROM filemeta WHERE dirhash=$1 AND name=$2 AND directory=$3",
    delete="DELETE FROM filemeta WHERE dirhash=$1 AND name=$2 AND directory=$3",
    delete_folder_children="DELETE FROM filemeta WHERE dirhash=$1 AND directory=$2",
    list_exclusive=(
        "SELECT name, meta FROM filemeta WHERE dirhash=$1 AND name>$2 AND"
        " directory=$3 ORDER BY name ASC LIMIT $4"
    ),
    list_inclusive=(
        "SELECT name, meta FROM filemeta WHERE dirhash=$1 AND name>=$2 AND"
        " directory=$3 ORDER BY name ASC LIMIT $4"
    ),
)


class AbstractSqlStore(FilerStore):
    """FilerStore over any DB-API connection + SqlDialect
    (abstract_sql_store.go:61-185 method-for-method)."""

    name = "sql"

    def __init__(self, conn, dialect: SqlDialect):
        self._conn = conn
        self._dialect = dialect
        self._lock = threading.RLock()
        self._tx_depth = 0
        with self._lock:
            cur = self._conn.cursor()
            cur.execute(dialect.create_table)
            cur.close()
            self._conn.commit()

    def _exec(self, sql: str, args: tuple) -> None:
        with self._lock:
            cur = self._conn.cursor()
            cur.execute(sql, args)
            cur.close()
            if self._tx_depth == 0:
                self._conn.commit()

    @staticmethod
    def _is_duplicate_key(exc: BaseException) -> bool:
        """DB-API drivers all subclass their duplicate-key error from a
        class named IntegrityError (PEP 249); anything else (disk full,
        connection lost) must propagate, not degrade to UPDATE."""
        return any(
            k.__name__ == "IntegrityError" for k in type(exc).__mro__
        )

    def insert_entry(self, entry: Entry) -> None:
        d, name = split_path(entry.full_path)
        meta = entry.encode()
        try:
            self._exec(
                self._dialect.insert, (hash_string_to_long(d), name, d, meta)
            )
        except Exception as e:
            if not self._is_duplicate_key(e):
                raise
            # the reference's filer calls UpdateEntry when the entry
            # exists; our Filer reuses insert for overwrite, so a
            # duplicate-key insert degrades to the dialect's UPDATE
            self.update_entry(entry)

    def update_entry(self, entry: Entry) -> None:
        d, name = split_path(entry.full_path)
        self._exec(
            self._dialect.update,
            (entry.encode(), hash_string_to_long(d), name, d),
        )

    def find_entry(self, full_path: str) -> Entry:
        d, name = split_path(full_path)
        with self._lock:
            cur = self._conn.cursor()
            cur.execute(self._dialect.find, (hash_string_to_long(d), name, d))
            row = cur.fetchone()
            cur.close()
        if row is None:
            raise EntryNotFound(full_path)
        return Entry.decode(full_path, row[0])

    def delete_entry(self, full_path: str) -> None:
        d, name = split_path(full_path)
        self._exec(self._dialect.delete, (hash_string_to_long(d), name, d))

    def delete_folder_children(self, full_path: str) -> None:
        d = normalize_path(full_path)
        self._exec(
            self._dialect.delete_folder_children, (hash_string_to_long(d), d)
        )

    def list_directory_entries(
        self, dir_path, start_file_name, include_start, limit
    ):
        d = normalize_path(dir_path)
        sql = (
            self._dialect.list_inclusive
            if include_start
            else self._dialect.list_exclusive
        )
        with self._lock:
            cur = self._conn.cursor()
            cur.execute(sql, (hash_string_to_long(d), start_file_name, d, limit))
            rows = cur.fetchall()
            cur.close()
        out = []
        for name, meta in rows:
            # binary-protocol drivers (pg_driver) return text columns
            # as raw bytes; sqlite returns str
            if isinstance(name, bytes):
                name = name.decode()
            out.append(Entry.decode(child_path(d, name), meta))
        return out

    # tx: same deferred-commit protocol as the embedded SqliteStore;
    # drivers that expose begin() (pg_driver) open a server-side
    # transaction here — sqlite3 begins implicitly on first statement
    def begin_transaction(self) -> None:
        self._lock.acquire()
        self._tx_depth += 1
        begin = getattr(self._conn, "begin", None)
        if begin is not None and self._tx_depth == 1:
            begin()

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


def new_sqlite_sql_store(path: str = ":memory:") -> AbstractSqlStore:
    """The `sql` store kind: the abstract layer over stdlib sqlite3 —
    the tested driver for the dialect machinery."""
    import sqlite3

    conn = sqlite3.connect(path, check_same_thread=False)
    return AbstractSqlStore(conn, SQLITE_DIALECT)


def new_postgres_store(path: str = "") -> AbstractSqlStore:
    """The postgres kind over the in-repo wire-protocol driver
    (filer/pg_driver.py) — no psycopg2; gated on connectivity.

    `path` is "host:port" or "host:port/database?user=U&password=P"
    (defaults: 5432 / seaweedfs / seaweedfs / empty password)."""
    from seaweedfs_tpu_torch.filer.pg_driver import PgConnection

    raw = path or "localhost:5432"
    host, port, user, password, database = _parse_db_path(
        raw, 5432, "postgres"
    )
    try:
        conn = PgConnection(
            host, port, user=user, password=password, database=database
        )
    except OSError as e:
        raise RuntimeError(
            f"filer store 'postgres' cannot reach a server at {raw!r} "
            f"({e}); start one (with the filemeta table — the dialect "
            "DDL is POSTGRES_DIALECT.create_table), or use an embedded "
            "kind: memory | sqlite | sql | sortedlog | lsm"
        ) from e
    return AbstractSqlStore(conn, POSTGRES_DIALECT)


def _parse_db_path(raw: str, default_port: int, kind: str):
    """host:port[/database?user=U&password=P] → connection params."""
    import urllib.parse

    hostport, _, rest = raw.partition("/")
    host, _, port = hostport.partition(":")
    try:
        port_num = int(port or default_port)
    except ValueError:
        raise RuntimeError(
            f"filer store {kind!r}: bad port in {raw!r}; expected "
            "host:port[/database?user=U&password=P]"
        ) from None
    database, user, password = "seaweedfs", "seaweedfs", ""
    if rest:
        dbpart, _, query = rest.partition("?")
        if dbpart:
            database = dbpart
        params = dict(urllib.parse.parse_qsl(query))
        user = params.get("user", user)
        password = params.get("password", password)
    return host or "localhost", port_num, user, password, database


def new_mysql_store(path: str = "") -> AbstractSqlStore:
    """The mysql kind over the in-repo wire-protocol driver
    (filer/mysql_driver.py) — no MySQLdb/pymysql; gated on
    connectivity. Same `path` shape as postgres."""
    from seaweedfs_tpu_torch.filer.mysql_driver import MysqlConnection

    raw = path or "localhost:3306"
    host, port, user, password, database = _parse_db_path(raw, 3306, "mysql")
    try:
        conn = MysqlConnection(
            host, port, user=user, password=password, database=database
        )
    except OSError as e:
        raise RuntimeError(
            f"filer store 'mysql' cannot reach a server at {raw!r} ({e}); "
            "start one (with the filemeta table — the dialect DDL is "
            "MYSQL_DIALECT.create_table), or use an embedded kind: "
            "memory | sqlite | sql | sortedlog | lsm"
        ) from e
    return AbstractSqlStore(conn, MYSQL_DIALECT)


def new_gated_sql_store(kind: str, path: str = "") -> AbstractSqlStore:
    """Both SQL kinds now run on in-repo wire drivers, gated on
    connectivity rather than client libraries."""
    if kind == "postgres":
        return new_postgres_store(path)
    if kind == "mysql":
        return new_mysql_store(path)
    raise ValueError(f"not a SQL store kind: {kind!r}")
