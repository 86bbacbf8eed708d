"""Local-directory remote tier: a fake object store on a plain
directory, for tests/chaos/bench runs that need a real BackendStorage
with zero network. Keys are flat file names under the configured dir;
ranged reads are preads — the semantics (opaque keys, upload/download/
delete, ranged read_at) mirror backend_s3 exactly, so anything proven
against `dir.default` holds structurally for `s3.default`."""

from __future__ import annotations

import os
import uuid

from seaweedfs_tpu_torch.storage import backend as b
from seaweedfs_tpu_torch.util import durable

_COPY_CHUNK = 4 << 20


class DirStorageFile(b.BackendStorageFile):
    def __init__(self, path: str, file_size: int):
        self.path = path
        self.file_size = file_size

    def read_at(self, length: int, offset: int) -> bytes:
        with open(self.path, "rb") as f:
            return os.pread(f.fileno(), length, offset)

    def write_at(self, data: bytes, offset: int) -> int:
        raise IOError("dir tier volumes are sealed (read-only)")

    def truncate(self, size: int) -> None:
        raise IOError("dir tier volumes are sealed (read-only)")

    def close(self) -> None:
        pass

    def get_stat(self) -> tuple[int, float]:
        st = os.stat(self.path)
        return st.st_size, st.st_mtime

    def name(self) -> str:
        return self.path


class DirBackendStorage(b.BackendStorage):
    storage_type = "dir"

    def __init__(self, instance_id: str, props: dict):
        self.id = instance_id
        self.directory = props["dir"]
        self._props = dict(props)
        os.makedirs(self.directory, exist_ok=True)

    def to_properties(self) -> dict:
        return {k: str(v) for k, v in self._props.items()}

    def _path(self, key: str) -> str:
        return os.path.join(self.directory, key)

    def new_storage_file(self, key: str, file_size: int) -> DirStorageFile:
        return DirStorageFile(self._path(key), file_size)

    def copy_file(self, local_path: str, attributes: dict, progress=None):
        key = f"{uuid.uuid4().hex}{attributes.get('ext', '.dat')}"
        size = os.path.getsize(local_path)
        tmp = self._path(key) + ".part"
        done = 0
        with open(local_path, "rb") as src, open(tmp, "wb") as dst:
            while True:
                chunk = src.read(_COPY_CHUNK)
                if not chunk:
                    break
                dst.write(chunk)
                done += len(chunk)
                if progress is not None:
                    progress(done, done * 100.0 / max(1, size))
            dst.flush()
            os.fsync(dst.fileno())
        # publish: a crash mid-upload leaves only a .part, never a
        # half-written key a later download would trust
        os.replace(tmp, self._path(key))
        durable.fsync_dir(self.directory)
        return key, size

    def download_file(self, local_path: str, key: str, progress=None) -> int:
        size = os.path.getsize(self._path(key))
        done = 0
        with open(self._path(key), "rb") as src, open(local_path, "wb") as dst:
            while True:
                chunk = src.read(_COPY_CHUNK)
                if not chunk:
                    break
                dst.write(chunk)
                done += len(chunk)
                if progress is not None:
                    progress(done, done * 100.0 / max(1, size))
        return size

    def delete_file(self, key: str) -> None:
        try:
            os.remove(self._path(key))
        except FileNotFoundError:
            pass


def _factory(instance_id: str, props: dict) -> DirBackendStorage:
    return DirBackendStorage(instance_id, props)


b.register_backend_factory("dir", _factory)
