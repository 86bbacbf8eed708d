"""Storage-backend SPI: where a volume's sealed .dat bytes live.

Behavioral match of reference weed/storage/backend/backend.go:15-46:

  BackendStorageFile  random-access surface over one volume's data
                      (local disk file, or ranged reads against a
                      remote object store)
  BackendStorage      a configured remote tier (e.g. one S3 bucket):
                      copy a sealed .dat up, stream it back down,
                      open a BackendStorageFile over the remote copy
  registry            type → factory; "s3.default"-style instance
                      names built from TOML config
                      (LoadConfiguration, backend.go:47-76)

The hot volume path stays on plain local files; remote tiers serve
sealed (read-only) volumes — the warm/cold tier the
VolumeTierMoveDatToRemote/FromRemote RPCs manage.

The port of seaweedfs_tpu/storage/backend.py.
"""

from __future__ import annotations

import os
import time
from typing import Callable, Optional

ProgressFn = Optional[Callable[[int, float], None]]


class BackendStorageFile:
    """Random-access file surface (io.ReaderAt/WriterAt analogue)."""

    def read_at(self, length: int, offset: int) -> bytes:
        raise NotImplementedError

    def write_at(self, data: bytes, offset: int) -> int:
        raise NotImplementedError

    def truncate(self, size: int) -> None:
        raise NotImplementedError

    def close(self) -> None:
        raise NotImplementedError

    def get_stat(self) -> tuple[int, float]:
        """(size bytes, mtime seconds)."""
        raise NotImplementedError

    def name(self) -> str:
        raise NotImplementedError


class DiskFile(BackendStorageFile):
    """Local-disk backend (backend/disk_file.go)."""

    def __init__(self, path: str):
        self.path = path
        if not os.path.exists(path):
            with open(path, "wb"):
                pass
        self.f = open(path, "r+b")

    def read_at(self, length: int, offset: int) -> bytes:
        self.f.seek(offset)
        return self.f.read(length)

    def write_at(self, data: bytes, offset: int) -> int:
        self.f.seek(offset)
        n = self.f.write(data)
        return n

    def truncate(self, size: int) -> None:
        self.f.truncate(size)

    def flush(self) -> None:
        self.f.flush()

    def close(self) -> None:
        self.f.close()

    def get_stat(self) -> tuple[int, float]:
        st = os.fstat(self.f.fileno())
        return st.st_size, st.st_mtime

    def name(self) -> str:
        return self.path


class BackendStorage:
    """One configured remote tier (backend.go BackendStorage)."""

    storage_type = ""
    id = ""

    @property
    def name(self) -> str:
        return f"{self.storage_type}.{self.id}"

    def to_properties(self) -> dict:
        raise NotImplementedError

    def new_storage_file(self, key: str, file_size: int) -> BackendStorageFile:
        raise NotImplementedError

    def copy_file(
        self, local_path: str, attributes: dict, progress: ProgressFn = None
    ) -> tuple[str, int]:
        """Upload; returns (remote key, size)."""
        raise NotImplementedError

    def download_file(
        self, local_path: str, key: str, progress: ProgressFn = None
    ) -> int:
        raise NotImplementedError

    def delete_file(self, key: str) -> None:
        raise NotImplementedError


# ---------------------------------------------------------------------------
# registry (backend.go BackendStorageFactories / BackendStorages)

_FACTORIES: dict[str, Callable[..., BackendStorage]] = {}
BACKEND_STORAGES: dict[str, BackendStorage] = {}


def register_backend_factory(
    storage_type: str, factory: Callable[..., BackendStorage]
) -> None:
    _FACTORIES[storage_type] = factory


def backend_name_to_type_id(name: str) -> tuple[str, str]:
    """"s3.default" → ("s3", "default"); bare "s3" → ("s3", "default")."""
    if "." in name:
        t, _, i = name.partition(".")
        return t, i
    return name, "default"


def register_backend(storage: BackendStorage) -> None:
    BACKEND_STORAGES[storage.name] = storage


def get_backend(name: str) -> BackendStorage | None:
    t, i = backend_name_to_type_id(name)
    return BACKEND_STORAGES.get(f"{t}.{i}")


def load_backend_config(cfg: dict) -> None:
    """Build backend instances from a config tree shaped like the
    reference's storage.toml:

        {"s3": {"default": {"enabled": True, "endpoint": ..., ...}}}
    """
    for storage_type, instances in (cfg or {}).items():
        factory = _FACTORIES.get(storage_type)
        if factory is None:
            raise ValueError(f"backend storage type {storage_type!r} not found")
        for instance_id, props in (instances or {}).items():
            if not props.get("enabled"):
                continue
            register_backend(factory(instance_id, props))


def _ensure_builtin_factories() -> None:
    from seaweedfs_tpu_torch.storage import backend_dir  # noqa: F401
    from seaweedfs_tpu_torch.storage import backend_s3  # noqa: F401


_ensure_builtin_factories_done = False


def ensure_builtin_factories() -> None:
    global _ensure_builtin_factories_done
    if not _ensure_builtin_factories_done:
        _ensure_builtin_factories()
        _ensure_builtin_factories_done = True
