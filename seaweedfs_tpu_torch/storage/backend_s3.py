"""S3 remote tier: sealed .dat files living in an S3-compatible bucket.

Behavioral match of reference
weed/storage/backend/s3_backend/s3_backend.go:29-175: CopyFile uploads
the sealed volume data, DownloadFile streams it back, and
S3StorageFile serves ReadAt as ranged GETs so a tiered volume's
needles are readable without the local .dat. Works against any
S3-compatible endpoint — including this repo's own S3 gateway, which
is how the tests exercise it with zero external dependencies."""

from __future__ import annotations

import time
import uuid

from seaweedfs_tpu_torch.s3api.client import S3Client
from seaweedfs_tpu_torch.storage import backend as b


class S3StorageFile(b.BackendStorageFile):
    def __init__(self, storage: "S3BackendStorage", key: str, file_size: int):
        self.storage = storage
        self.key = key
        self.file_size = file_size

    def read_at(self, length: int, offset: int) -> bytes:
        if offset >= self.file_size:
            return b""
        length = min(length, self.file_size - offset)
        return self.storage.client.get_object(
            self.storage.bucket, self.key, offset, length
        )

    def write_at(self, data: bytes, offset: int) -> int:
        raise IOError("s3 tier volumes are sealed (read-only)")

    def truncate(self, size: int) -> None:
        raise IOError("s3 tier volumes are sealed (read-only)")

    def close(self) -> None:
        pass

    def get_stat(self) -> tuple[int, float]:
        return self.file_size, time.time()

    def name(self) -> str:
        return f"s3://{self.storage.bucket}/{self.key}"


class S3BackendStorage(b.BackendStorage):
    storage_type = "s3"

    def __init__(self, instance_id: str, props: dict):
        self.id = instance_id
        self.endpoint = props["endpoint"]
        self.bucket = props["bucket"]
        self.region = props.get("region", "us-east-1")
        self._props = dict(props)
        self.client = S3Client(
            self.endpoint,
            props.get("aws_access_key_id", props.get("access_key", "")),
            props.get("aws_secret_access_key", props.get("secret_key", "")),
            region=self.region,
        )

    def to_properties(self) -> dict:
        return {k: str(v) for k, v in self._props.items() if "secret" not in k}

    def new_storage_file(self, key: str, file_size: int) -> S3StorageFile:
        return S3StorageFile(self, key, file_size)

    def copy_file(self, local_path: str, attributes: dict, progress=None):
        """Streamed upload — a 30 GB sealed .dat never lives in memory
        as one buffer (the reference streams via multipart upload)."""
        import os

        key = f"{uuid.uuid4().hex}{attributes.get('ext', '.dat')}"
        size = os.path.getsize(local_path)
        with open(local_path, "rb") as f:
            self.client.put_object_stream(self.bucket, key, f, size, progress)
        return key, size

    def download_file(self, local_path: str, key: str, progress=None) -> int:
        return self.client.get_object_to_file(
            self.bucket, key, local_path, progress
        )

    def delete_file(self, key: str) -> None:
        self.client.delete_object(self.bucket, key)


b.register_backend_factory("s3", S3BackendStorage)
