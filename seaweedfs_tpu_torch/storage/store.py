"""Store: the per-server storage engine over N disk locations.

Behavioral match of reference weed/storage/store.go + store_ec.go
(local parts): vid→Volume dispatch for write/read/delete, volume
allocate/mount/delete, EC volume lookup and shard mount/unmount, and
heartbeat assembly (the master-facing volume + EC-shard inventory).

The port of seaweedfs_tpu/storage/store.py: `ec_backend` and `device`
are threaded down to every DiskLocation and EcVolume, so EC decodes
run K1 on the card unless the caller asks for another backend or the
CPU.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Optional

from seaweedfs_tpu_torch.ec.ec_volume import EcVolume
from seaweedfs_tpu_torch.storage.disk_location import DiskLocation
from seaweedfs_tpu_torch.storage.needle import Needle
from seaweedfs_tpu_torch.storage.replica_placement import ReplicaPlacement
from seaweedfs_tpu_torch.storage.ttl import TTL
from seaweedfs_tpu_torch.storage.volume import NeedleNotFound, Volume


@dataclass
class VolumeInfo:
    """One volume's heartbeat row (pb VolumeInformationMessage)."""

    id: int
    size: int
    collection: str
    file_count: int
    delete_count: int
    deleted_byte_count: int
    read_only: bool
    replica_placement: int
    version: int
    ttl: int

    @staticmethod
    def from_volume(v: Volume) -> "VolumeInfo":
        # stats_snapshot holds the volume lock: the heartbeat thread
        # must not race commit_compact's .dat/.idx + needle-map swap —
        # an unlocked data_file_size() there seeks a CLOSED file, the
        # raised ValueError kills the heartbeat stream, the master's
        # liveness sweep drops the node's volumes, and the next
        # /dir/assign 500s ("no writable volumes").
        return VolumeInfo(
            id=v.id,
            collection=v.collection,
            replica_placement=v.super_block.replica_placement.to_byte(),
            version=v.version,
            ttl=v.ttl.to_uint32(),
            **v.stats_snapshot(),
        )


@dataclass
class EcShardInfo:
    """One EC volume's heartbeat row (pb VolumeEcShardInformationMessage):
    vid + bitmask of locally mounted shards."""

    id: int
    collection: str
    ec_index_bits: int


@dataclass
class ScrubStatInfo:
    """One volume's scrub-plane heartbeat row (pb ScrubStat) as the
    master's topology stores it per data node."""

    volume_id: int
    is_ec: bool
    last_sweep_unix: int
    scanned_bytes: int
    corruptions_found: int
    quarantined_shard_bits: int
    last_error: str


@dataclass
class Heartbeat:
    max_file_key: int
    volumes: list[VolumeInfo] = field(default_factory=list)
    ec_shards: list[EcShardInfo] = field(default_factory=list)


class Store:
    def __init__(
        self,
        directories: list[str],
        max_volume_counts: list[int] | None = None,
        ec_backend: str | None = None,
        needle_map_kind: str = "memory",
        device=None,
    ):
        counts = max_volume_counts or [7] * len(directories)
        # `ec.codec`: cuda|native|cpu, None = the default (cuda unless
        # WEED_EC_CODEC names another); `device` for the cuda backend
        # (None = the card, "cpu" = the kernels' plain versions)
        self.ec_backend = ec_backend
        self.device = device
        self.needle_map_kind = needle_map_kind
        # metric label for this server's scrub gauges ("host:port"; the
        # volume server sets it right after construction)
        self.node_label = ""
        # invoked after any change to the heartbeat-visible inventory
        # (volume add/delete/mount/unmount, readonly flips, EC shard
        # mount/unmount). The volume server points this at its
        # heartbeat wake-up so deltas reach the master immediately —
        # the role of the reference's NewVolumesChan/NewEcShardsChan
        # pushes (store.go:110-120, volume_grpc_client_to_master.go:150-170).
        # The ordering guarantee of the EC migration pipeline (shards
        # mounted and REGISTERED before the volume is deleted) depends
        # on this, not on the periodic tick.
        self.notify_change: callable = lambda: None
        # scrub plane: vid → {shard id → reason} for every EC shard
        # quarantined on this server (truncation caught by a foreground
        # read, or corruption found by the background scrubber). Rides
        # heartbeats as ScrubStat.quarantined_shard_bits and the volume
        # server's /status JSON.
        self.quarantined: dict[int, dict[int, str]] = {}
        self.locations = [
            DiskLocation(
                d, c, ec_backend=ec_backend, needle_map_kind=needle_map_kind,
                device=device,
            )
            for d, c in zip(directories, counts)
        ]
        for loc in self.locations:
            loc.load_existing_volumes()
            for ev in loc.ec_volumes.values():
                ev.on_quarantine = self.note_quarantine

    # --- volume management (store.go:165-226) ---
    def has_volume(self, vid: int) -> bool:
        return self.find_volume(vid) is not None

    def find_volume(self, vid: int) -> Optional[Volume]:
        for loc in self.locations:
            v = loc.find_volume(vid)
            if v is not None:
                return v
        return None

    def find_free_location(self) -> Optional[DiskLocation]:
        best, most_free = None, 0
        for loc in self.locations:
            free = loc.max_volume_count - len(loc.volumes)
            if free > most_free:
                best, most_free = loc, free
        return best

    def add_volume(
        self,
        vid: int,
        collection: str = "",
        replica_placement: str = "000",
        ttl: str = "",
        version: int = 3,
    ) -> Volume:
        if self.has_volume(vid):
            raise ValueError(f"volume {vid} already exists")
        loc = self.find_free_location()
        if loc is None:
            raise RuntimeError("no free disk location")
        v = Volume(
            loc.directory,
            vid,
            collection,
            replica_placement=ReplicaPlacement.parse(replica_placement),
            ttl=TTL.parse(ttl),
            version=version,
            needle_map_kind=self.needle_map_kind,
        )
        loc.volumes[vid] = v
        self.notify_change()
        return v

    def delete_volume(self, vid: int) -> bool:
        for loc in self.locations:
            if loc.delete_volume(vid):
                self.notify_change()
                return True
        return False

    def mount_volume(self, vid: int) -> bool:
        for loc in self.locations:
            if loc.mount_volume(vid):
                self.notify_change()
                return True
        return False

    def unmount_volume(self, vid: int) -> bool:
        for loc in self.locations:
            if loc.unmount_volume(vid):
                self.notify_change()
                return True
        return False

    def mark_volume_readonly(self, vid: int) -> bool:
        v = self.find_volume(vid)
        if v is None:
            return False
        v.read_only = True
        self.notify_change()
        return True

    def mark_volume_writable(self, vid: int) -> bool:
        v = self.find_volume(vid)
        if v is None:
            return False
        v.read_only = False
        self.notify_change()
        return True

    # --- needle IO (store.go:227-264) ---
    def write_needle(
        self, vid: int, n: Needle, stages: dict | None = None
    ) -> tuple[int, bool]:
        v = self.find_volume(vid)
        if v is None:
            raise NeedleNotFound(f"volume {vid} not found")
        _, size, unchanged = v.write_needle(n, stages=stages)
        return size, unchanged

    def read_needle(self, vid: int, needle_id: int, cookie: int | None = None) -> Needle:
        v = self.find_volume(vid)
        if v is not None:
            return v.read_needle(needle_id, cookie)
        ev = self.find_ec_volume(vid)
        if ev is not None:
            return ev.read_needle(needle_id)
        raise NeedleNotFound(f"volume {vid} not found")

    def delete_needle(self, vid: int, n: Needle) -> int:
        v = self.find_volume(vid)
        if v is None:
            raise NeedleNotFound(f"volume {vid} not found")
        return v.delete_needle(n)

    # --- EC (store_ec.go local parts) ---
    def find_ec_volume(self, vid: int) -> Optional[EcVolume]:
        for loc in self.locations:
            ev = loc.ec_volumes.get(vid)
            if ev is not None:
                return ev  # type: ignore[return-value]
        return None

    def mount_ec_shards(self, vid: int, collection: str, shard_ids: list[int]) -> EcVolume:
        ev = self.find_ec_volume(vid)
        if ev is None:
            loc = self.locations[0]
            ev = EcVolume(
                loc.directory, vid, collection, backend=self.ec_backend, device=self.device
            )
            ev.on_quarantine = self.note_quarantine
            loc.ec_volumes[vid] = ev
        for sid in shard_ids:
            ev.mount_shard(sid)
            self.clear_quarantine(vid, sid)
        self.notify_change()
        return ev

    def unmount_ec_shards(self, vid: int, shard_ids: list[int]) -> None:
        ev = self.find_ec_volume(vid)
        if ev is None:
            return
        for sid in shard_ids:
            ev.unmount_shard(sid)
        if not ev.shards and getattr(ev, "remote", None) is None:
            for loc in self.locations:
                loc.ec_volumes.pop(vid, None)
            # the whole EC volume left this node: its local quarantine
            # records are moot
            if self.quarantined.pop(vid, None):
                self._update_quarantine_gauge()
        self.notify_change()

    # --- scrub-plane quarantine registry ---
    def note_quarantine(self, vid: int, shard_id: int, reason: str) -> None:
        """EcVolume.on_quarantine target: record + force a delta beat
        so the master hears about the lost shard NOW, not on the tick."""
        self.quarantined.setdefault(vid, {})[shard_id] = reason
        self._update_quarantine_gauge()
        self.notify_change()

    def quarantined_shard_bits(self, vid: int) -> int:
        bits = 0
        for sid in self.quarantined.get(vid, ()):
            bits |= 1 << sid
        return bits

    def clear_quarantine(self, vid: int, shard_id: int) -> None:
        per_vid = self.quarantined.get(vid)
        if per_vid and per_vid.pop(shard_id, None) is not None:
            if not per_vid:
                self.quarantined.pop(vid, None)
            self._update_quarantine_gauge()

    def quarantined_shard_bits(self, vid: int) -> int:
        bits = 0
        for sid in self.quarantined.get(vid, ()):
            bits |= 1 << sid
        return bits

    def _update_quarantine_gauge(self) -> None:
        from seaweedfs_tpu_torch.stats.metrics import SCRUB_QUARANTINED

        SCRUB_QUARANTINED.set(
            sum(len(d) for d in self.quarantined.values()),
            self.node_label,
        )

    # --- heartbeat (store.go CollectHeartbeat) ---
    def collect_heartbeat(self) -> Heartbeat:
        hb = Heartbeat(max_file_key=0)
        for loc in self.locations:
            # list() snapshots: allocate/delete/mount RPCs (and the
            # repair scheduler's VolumeCopy) mutate these dicts from
            # other threads; iterating the live dict here killed the
            # heartbeat STREAM with "dictionary changed size" — the
            # master then saw the node flap
            for v in list(loc.volumes.values()):
                try:
                    info = VolumeInfo.from_volume(v)
                except ValueError:
                    # closed by a delete or unmount since the snapshot
                    # (its .dat seeks as a closed file): it is gone from
                    # the next beat, and the stream must not break
                    continue
                hb.max_file_key = max(hb.max_file_key, v.max_file_key())
                hb.volumes.append(info)
            for vid, ev in list(loc.ec_volumes.items()):
                bits = 0
                # serving ids = local mounts ∪ tiered remote shards: a
                # fully tiered volume must keep routing to this node
                # and must not read as "missing shards" to the repair
                # scheduler (docs/TIERING.md)
                for sid in ev.serving_shard_ids():  # type: ignore[attr-defined]
                    bits |= 1 << sid
                hb.ec_shards.append(
                    EcShardInfo(vid, ev.collection, bits)  # type: ignore[attr-defined]
                )
        return hb

    def close(self) -> None:
        for loc in self.locations:
            loc.close()
