"""`.vif` — per-volume tier metadata (remote file locations).

Behavioral match of reference weed/pb/volume_info.go: the VolumeInfo
protobuf (volume_server.proto:346-358) serialized as jsonpb next to
the volume files. Field names follow jsonpb camelCase so a .vif
written here parses in the reference and vice versa."""

from __future__ import annotations

import json
import os
from dataclasses import dataclass, field

from seaweedfs_tpu_torch.util import durable


@dataclass
class RemoteFile:
    backend_type: str = ""
    backend_id: str = ""
    key: str = ""
    offset: int = 0
    file_size: int = 0
    modified_time: int = 0
    extension: str = ""

    @property
    def backend_name(self) -> str:
        return f"{self.backend_type}.{self.backend_id}"

    def to_json(self) -> dict:
        return {
            "backendType": self.backend_type,
            "backendId": self.backend_id,
            "key": self.key,
            "offset": str(self.offset),
            "fileSize": str(self.file_size),
            "modifiedTime": str(self.modified_time),
            "extension": self.extension,
        }

    @classmethod
    def from_json(cls, d: dict) -> "RemoteFile":
        return cls(
            backend_type=d.get("backendType", ""),
            backend_id=d.get("backendId", ""),
            key=d.get("key", ""),
            offset=int(d.get("offset", 0) or 0),
            file_size=int(d.get("fileSize", 0) or 0),
            modified_time=int(d.get("modifiedTime", 0) or 0),
            extension=d.get("extension", ""),
        )


@dataclass
class VolumeInfo:
    files: list[RemoteFile] = field(default_factory=list)
    version: int = 0

    def has_remote_file(self) -> bool:
        return bool(self.files)


def maybe_load_volume_info(file_name: str) -> tuple[VolumeInfo, bool]:
    """(info, found-with-remote-files) — never returns None
    (MaybeLoadVolumeInfo, volume_info.go:18)."""
    vi = VolumeInfo()
    if not os.path.exists(file_name):
        return vi, False
    try:
        with open(file_name) as f:
            d = json.load(f)
    except (OSError, ValueError):
        return vi, False
    vi.version = int(d.get("version", 0) or 0)
    vi.files = [RemoteFile.from_json(x) for x in d.get("files", [])]
    return vi, vi.has_remote_file()


def save_volume_info(file_name: str, vi: VolumeInfo) -> None:
    tmp = file_name + ".tmp"
    with open(tmp, "w") as f:
        json.dump(
            {
                "files": [rf.to_json() for rf in vi.files],
                "version": str(vi.version),
            },
            f,
            indent=2,
        )
    # durable publish: the .vif decides at load time whether the .dat
    # is local or remote — a lost/torn one after tier_upload deleted
    # the local .dat would leave the volume unloadable
    durable.publish(tmp, file_name)
