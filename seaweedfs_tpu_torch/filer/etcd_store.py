"""etcd-backed filer store over the etcd v3 gateway REST protocol.

Behavioral match of weed/filer2/etcd/etcd_store.go: one KV pair per
entry with key = `<dir>\\x00<name>` (DIR_FILE_SEPARATOR, :16), plain
Put/Get/Delete, directory listing and recursive delete as prefix
ranges over `<dir>\\x00`. The reference rides clientv3; this store
speaks the grpc-gateway REST surface (/v3/kv/range, /v3/kv/put,
/v3/kv/deleterange) — the same wire the EtcdSequencer uses — so the
gate is connectivity (tests/cloud_fakes.FakeEtcd serves offline).

The port of seaweedfs_tpu/filer/etcd_store.py.
"""

from __future__ import annotations

import base64

from seaweedfs_tpu_torch.filer.entry import Entry, child_path, normalize_path, split_path
from seaweedfs_tpu_torch.filer.filerstore import EntryNotFound, FilerStore
from seaweedfs_tpu_torch.util.etcd import EtcdHttpError, EtcdKv

DIR_FILE_SEPARATOR = b"\x00"


def _b64(b: bytes) -> str:
    return base64.b64encode(b).decode()


def _prefix_end(prefix: bytes) -> bytes:
    """etcd prefix-scan upper bound: prefix with its last byte + 1."""
    p = bytearray(prefix)
    for i in reversed(range(len(p))):
        if p[i] < 0xFF:
            p[i] += 1
            return bytes(p[: i + 1])
    return b"\x00"  # all-0xff prefix: scan to the end of the keyspace


class EtcdFilerStore(FilerStore):
    name = "etcd"

    def __init__(self, urls: str):
        self._kv = EtcdKv(urls)
        try:
            self._kv.call("range", {"key": _b64(b"\x00")})  # connectivity
        except EtcdHttpError as e:
            raise RuntimeError(
                f"filer store 'etcd': {urls!r} answered but not as an "
                f"etcd v3 gateway ({e}); check the endpoint/gateway "
                "config, or use an embedded kind"
            ) from e
        except OSError as e:
            raise RuntimeError(
                f"filer store 'etcd' cannot reach {urls!r} ({e}); start "
                "etcd, or use an embedded kind: memory | sqlite | sql | "
                "sortedlog | lsm"
            ) from e

    @staticmethod
    def _key(directory: str, name: str) -> bytes:
        return directory.encode() + DIR_FILE_SEPARATOR + name.encode()

    def insert_entry(self, entry: Entry) -> None:
        d, name = split_path(entry.full_path)
        self._kv.call(
            "put",
            {"key": _b64(self._key(d, name)), "value": _b64(entry.encode())},
        )

    update_entry = insert_entry

    def find_entry(self, full_path: str) -> Entry:
        d, name = split_path(full_path)
        resp = self._kv.call("range", {"key": _b64(self._key(d, name))})
        kvs = resp.get("kvs", [])
        if not kvs:
            raise EntryNotFound(full_path)
        return Entry.decode(full_path, base64.b64decode(kvs[0]["value"]))

    def delete_entry(self, full_path: str) -> None:
        d, name = split_path(full_path)
        self._kv.call("deleterange", {"key": _b64(self._key(d, name))})

    def delete_folder_children(self, full_path: str) -> None:
        prefix = normalize_path(full_path).encode() + DIR_FILE_SEPARATOR
        self._kv.call(
            "deleterange",
            {"key": _b64(prefix), "range_end": _b64(_prefix_end(prefix))},
        )

    def list_directory_entries(
        self, dir_path, start_file_name, include_start, limit
    ):
        d = normalize_path(dir_path)
        prefix = d.encode() + DIR_FILE_SEPARATOR
        # server-side range start + limit: begin AT prefix+start (one
        # extra row covers the exclusive case) instead of shipping the
        # whole directory per page
        start_key = prefix + start_file_name.encode()
        resp = self._kv.call(
            "range",
            {
                "key": _b64(start_key),
                "range_end": _b64(_prefix_end(prefix)),
                "sort_target": "KEY",
                "sort_order": "ASCEND",
                "limit": str(limit + 1),
            },
        )
        out = []
        for kv in resp.get("kvs", []):
            key = base64.b64decode(kv["key"])
            name = key[len(prefix) :].decode()
            if start_file_name and not include_start and name <= start_file_name:
                continue
            out.append(
                Entry.decode(
                    child_path(d, name), base64.b64decode(kv["value"])
                )
            )
            if len(out) >= limit:
                break
        return out
