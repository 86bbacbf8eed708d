"""DiskLocation: one data directory of volumes and EC shards.

Behavioral match of reference weed/storage/disk_location.go +
disk_location_ec.go: scan the directory for `[collection_]<vid>.dat`
volumes and `[collection_]<vid>.ec00-13` shard sets, load them, and
serve vid→Volume / vid→EcVolume lookups. (The reference loads with an
8-way worker pool; volumes here load sequentially — directory scan is
not a hot path for this build.)

The port of seaweedfs_tpu/storage/disk_location.py. Every EcVolume it
mounts gets the location's `ec_backend` and `device`: by default the
cuda backend on the card, checked when the location is made.
"""

from __future__ import annotations

import os
import re
from typing import Optional

from seaweedfs_tpu_torch.storage.volume import Volume

_DAT_RE = re.compile(r"^(?:(?P<collection>.+)_)?(?P<vid>\d+)\.dat$")
_EC_RE = re.compile(r"^(?:(?P<collection>.+)_)?(?P<vid>\d+)\.ec(?P<shard>\d{2})$")


def parse_volume_file_name(name: str) -> tuple[str, int] | None:
    """volume file name → (collection, vid), or None if not a .dat."""
    m = _DAT_RE.match(name)
    if not m:
        return None
    return m.group("collection") or "", int(m.group("vid"))


def parse_ec_shard_file_name(name: str) -> tuple[str, int, int] | None:
    m = _EC_RE.match(name)
    if not m:
        return None
    return m.group("collection") or "", int(m.group("vid")), int(m.group("shard"))


class DiskLocation:
    def __init__(
        self,
        directory: str,
        max_volume_count: int = 7,
        ec_backend: str | None = None,
        needle_map_kind: str = "memory",
        device=None,
    ):
        from seaweedfs_tpu_torch.ec.codec import resolve_backend

        resolve_backend(ec_backend, device)  # no card, no cpu asked for: raise
        self.directory = directory
        self.max_volume_count = max_volume_count
        self.ec_backend = ec_backend  # `ec.codec` for EC volumes here
        self.device = device  # where their decodes run (None: the card)
        self.needle_map_kind = needle_map_kind  # -index memory|db
        self.volumes: dict[int, Volume] = {}
        # vid -> EcVolume; populated by load_existing_volumes and the
        # EC mount RPCs (ec/ec_volume.py)
        self.ec_volumes: dict[int, object] = {}

    def load_existing_volumes(self) -> None:
        os.makedirs(self.directory, exist_ok=True)
        for name in sorted(os.listdir(self.directory)):
            parsed = parse_volume_file_name(name)
            if parsed is None and name.endswith(".vif"):
                # remote-tiered volume: .dat lives in a backend; the
                # .vif + .idx are enough to load it read-only
                parsed = parse_volume_file_name(name[:-4] + ".dat")
            if parsed is None:
                continue
            collection, vid = parsed
            if vid in self.volumes:
                continue
            try:
                # repair: server startup is the exclusive owner of
                # these files — the one safe point to roll a crashed
                # vacuum commit forward/back and heal torn tails
                # (docs/ANALYSIS.md v3); follower/worker opens must
                # never pass it
                self.volumes[vid] = Volume(
                    self.directory,
                    vid,
                    collection,
                    create=False,
                    needle_map_kind=self.needle_map_kind,
                    repair=True,
                )
            except (OSError, ValueError):
                continue  # unloadable volume; reference logs and skips
        self._load_ec_shards()

    def _load_ec_shards(self) -> None:
        from seaweedfs_tpu_torch.ec.ec_volume import EcVolume

        shard_sets: dict[tuple[str, int], list[int]] = {}
        for name in sorted(os.listdir(self.directory)):
            parsed = parse_ec_shard_file_name(name)
            if parsed is None and name.endswith(".evf"):
                # fully tiered EC volume: zero local .ec?? files, but
                # the .evf + .ecx are enough to serve from the backend
                p = parse_volume_file_name(name[:-4] + ".dat")
                if p is not None:
                    shard_sets.setdefault((p[0], p[1]), [])
                continue
            if parsed is None:
                continue
            collection, vid, shard = parsed
            shard_sets.setdefault((collection, vid), []).append(shard)
        for (collection, vid), shards in shard_sets.items():
            if vid in self.ec_volumes:
                continue
            try:
                self.ec_volumes[vid] = EcVolume.load(
                    self.directory, vid, collection, backend=self.ec_backend,
                    device=self.device,
                )
            except (OSError, ValueError):
                continue

    def find_volume(self, vid: int) -> Optional[Volume]:
        return self.volumes.get(vid)

    def has_volume(self, vid: int) -> bool:
        return vid in self.volumes

    def delete_volume(self, vid: int) -> bool:
        v = self.volumes.pop(vid, None)
        if v is None:
            return False
        v.destroy()
        return True

    def unmount_volume(self, vid: int) -> bool:
        """Close and forget a volume, keeping its files on disk
        (disk_location.go UnloadVolume)."""
        v = self.volumes.pop(vid, None)
        if v is None:
            return False
        v.close()
        return True

    def mount_volume(self, vid: int) -> bool:
        """(Re)load one volume from this directory's files
        (disk_location.go LoadVolume)."""
        if vid in self.volumes:
            return True
        for name in sorted(os.listdir(self.directory)):
            parsed = parse_volume_file_name(name)
            if parsed is None or parsed[1] != vid:
                continue
            collection = parsed[0]
            try:
                # no repair here: a runtime remount can race a live
                # -shardWrites worker appending to the same files —
                # only the startup load (above) is provably exclusive
                self.volumes[vid] = Volume(
                    self.directory,
                    vid,
                    collection,
                    create=False,
                    needle_map_kind=self.needle_map_kind,
                )
                return True
            except (OSError, ValueError):
                return False
        return False

    def close(self) -> None:
        for v in self.volumes.values():
            v.close()
        for ev in self.ec_volumes.values():
            close = getattr(ev, "close", None)
            if close:
                close()
