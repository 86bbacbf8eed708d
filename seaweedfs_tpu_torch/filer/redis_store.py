"""Redis-backed filer store speaking RESP directly — no client library.

Behavioral match of weed/filer2/redis/universal_redis_store.go:

  * every entry is one string key: SET <fullpath> <meta bytes>
  * each directory keeps a set of child names for listing:
    SADD "<dir>\\x00" <name>  (DIR_LIST_MARKER suffix, :15)
  * FindEntry = GET, DeleteEntry = DEL + SREM from the parent set,
    listing = SMEMBERS + sort + slice + per-name GET (:119-160)
  * transactions are no-ops (:22-30) — redis single-key ops suffice

The reference rides go-redis; this store implements the RESP wire
protocol over one socket (the commands the model needs: SET GET DEL
SADD SREM SMEMBERS PING). The gate is connectivity: constructing dials
the server and raises with guidance when nothing answers — the in-repo
RESP fake (tests/cloud_fakes.FakeRedis) serves offline tests.

The port of seaweedfs_tpu/filer/redis_store.py.
"""

from __future__ import annotations

import socket
import threading

from seaweedfs_tpu_torch.filer.entry import Entry, child_path, normalize_path, split_path
from seaweedfs_tpu_torch.filer.filerstore import EntryNotFound, FilerStore

DIR_LIST_MARKER = "\x00"


class RespClient:
    """Minimal RESP2 client: one connection, inline pipelining-free."""

    def __init__(self, address: str, timeout: float = 10.0):
        host, _, port = address.partition(":")
        self.sock = socket.create_connection(
            (host, int(port or 6379)), timeout=timeout
        )
        self.sock.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, True)
        self.rfile = self.sock.makefile("rb")
        self._lock = threading.Lock()

    def close(self) -> None:
        for c in (self.rfile.close, self.sock.close):
            try:
                c()
            except OSError:
                pass

    def call(self, *args: bytes | str):
        """Send one command array, return the parsed reply
        (bytes | int | list | None; errors raise)."""
        out = bytearray(b"*%d\r\n" % len(args))
        for a in args:
            b = a.encode() if isinstance(a, str) else a
            out += b"$%d\r\n" % len(b) + b + b"\r\n"
        with self._lock:
            self.sock.sendall(out)
            return self._read_reply()

    def _read_reply(self):
        line = self.rfile.readline()
        if not line:
            raise ConnectionError("redis: connection closed")
        kind, rest = line[:1], line[1:].rstrip(b"\r\n")
        if kind == b"+":
            return rest
        if kind == b"-":
            raise RuntimeError(f"redis error: {rest.decode()}")
        if kind == b":":
            return int(rest)
        if kind == b"$":
            n = int(rest)
            if n < 0:
                return None
            data = self.rfile.read(n + 2)
            return data[:-2]
        if kind == b"*":
            n = int(rest)
            if n < 0:
                return None
            return [self._read_reply() for _ in range(n)]
        raise ValueError(f"redis: bad reply type {kind!r}")


class RedisStore(FilerStore):
    name = "redis"

    def __init__(self, address: str):
        try:
            self._client = RespClient(address)
            self._client.call("PING")
        except OSError as e:
            raise RuntimeError(
                f"filer store 'redis' cannot reach a server at {address!r} "
                f"({e}); start one (or use an embedded kind: memory | "
                "sqlite | sql | sortedlog | lsm)"
            ) from e

    @staticmethod
    def _dir_key(directory: str) -> str:
        return directory + DIR_LIST_MARKER

    def insert_entry(self, entry: Entry) -> None:
        d, name = split_path(entry.full_path)
        self._client.call("SET", entry.full_path, entry.encode())
        if name:
            self._client.call("SADD", self._dir_key(d), name)

    update_entry = insert_entry

    def find_entry(self, full_path: str) -> Entry:
        data = self._client.call("GET", full_path)
        if data is None:
            raise EntryNotFound(full_path)
        return Entry.decode(full_path, data)

    def delete_entry(self, full_path: str) -> None:
        d, name = split_path(full_path)
        self._client.call("DEL", full_path)
        if name:
            self._client.call("SREM", self._dir_key(d), name)

    def list_directory_entries(
        self, dir_path, start_file_name, include_start, limit
    ):
        d = normalize_path(dir_path)
        members = self._client.call("SMEMBERS", self._dir_key(d)) or []
        names = sorted(m.decode() for m in members)
        out = []
        for n in names:
            if start_file_name:
                if include_start and n < start_file_name:
                    continue
                if not include_start and n <= start_file_name:
                    continue
            path = child_path(d, n)
            data = self._client.call("GET", path)
            if data is None:
                continue  # expired/dangling member (reference skips too)
            out.append(Entry.decode(path, data))
            if len(out) >= limit:
                break
        return out

    def close(self) -> None:
        self._client.close()
