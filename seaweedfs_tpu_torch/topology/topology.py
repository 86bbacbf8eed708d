"""Topology: the master's cluster state and assignment brain.

Behavioral match of reference weed/topology/topology.go +
topology_ec.go + topology_event_handling.go: the DC/rack/node tree,
per-(collection, rp, ttl) volume layouts, the EC shard registry
(vid → shard → nodes), heartbeat-driven registration, max-volume-id
allocation, and lookup/pick-for-write used by /dir/assign and
/dir/lookup.

The reference replicates NextVolumeId through raft
(cluster_commands.go); here the max-vid counter sits behind the same
single-method seam (`IdGenerator`) so a consensus-backed generator can
replace the in-memory one without touching callers (SURVEY §7 "keep
the command-log interface").
"""

from __future__ import annotations

import threading
import time
from dataclasses import dataclass
from typing import Optional

from seaweedfs_tpu_torch.storage.store import EcShardInfo, VolumeInfo
from seaweedfs_tpu_torch.storage.ttl import TTL
from seaweedfs_tpu_torch.storage.replica_placement import ReplicaPlacement
from seaweedfs_tpu_torch.topology.node import DataCenter, DataNode, Node, Rack
from seaweedfs_tpu_torch.topology.volume_layout import VolumeLayout
from seaweedfs_tpu_torch.topology import volume_growth


class IdGenerator:
    """Monotonic volume-id allocator (raft MaxVolumeIdCommand seam)."""

    def __init__(self) -> None:
        self._max_vid = 0
        self._lock = threading.Lock()

    def next_volume_id(self) -> int:
        with self._lock:
            self._max_vid += 1
            return self._max_vid

    def peek(self) -> int:
        """Current max without allocating (raft leaders propose
        peek()+1 and let the replicated apply advance it)."""
        with self._lock:
            return self._max_vid

    def adjust_if_larger(self, vid: int) -> None:
        with self._lock:
            if vid > self._max_vid:
                self._max_vid = vid


@dataclass
class EcShardLocations:
    """vid → 14 lists of owning nodes (topology_ec.go EcShardLocations)."""

    collection: str
    locations: list[list[DataNode]]

    @classmethod
    def empty(cls, collection: str) -> "EcShardLocations":
        return cls(collection, [[] for _ in range(14)])


class Topology(Node):
    def __init__(self, volume_size_limit: int = 30 * 1024 * 1024 * 1024):
        super().__init__("")
        self.volume_size_limit = volume_size_limit
        self.id_gen = IdGenerator()
        # (collection, rp, ttl) -> VolumeLayout
        self._layouts: dict[tuple[str, str, str], VolumeLayout] = {}
        self.ec_shard_map: dict[int, EcShardLocations] = {}
        self._lock = threading.RLock()

    # --- tree ---
    def get_or_create_data_center(self, dc_id: str) -> DataCenter:
        return self.get_or_create(dc_id, DataCenter)  # type: ignore[return-value]

    def data_nodes(self) -> list[DataNode]:
        out = []
        for dc in self.children.values():
            for rack in dc.children.values():
                out.extend(rack.children.values())
        return out  # type: ignore[return-value]

    def get_layout(self, collection: str, rp: str, ttl: str) -> VolumeLayout:
        with self._lock:
            key = (collection, rp, ttl)
            layout = self._layouts.get(key)
            if layout is None:
                layout = VolumeLayout(rp, ttl, self.volume_size_limit)
                self._layouts[key] = layout
            return layout

    def collections(self) -> set[str]:
        with self._lock:
            names = {k[0] for k in self._layouts}
            names.update(loc.collection for loc in self.ec_shard_map.values())
            return names

    # --- heartbeat-driven registration (master_grpc_server.go:18) ---
    def register_data_node(
        self,
        ip: str,
        port: int,
        public_url: str = "",
        data_center: str = "DefaultDataCenter",
        rack: str = "DefaultRack",
        max_volumes: int = 7,
    ) -> DataNode:
        dc = self.get_or_create_data_center(data_center)
        r = dc.get_or_create_rack(rack)
        dn = r.new_data_node(
            f"{ip}:{port}", ip=ip, port=port, public_url=public_url, max_volumes=max_volumes
        )
        dn.last_seen = time.time()
        return dn

    def sync_volumes(self, dn: DataNode, infos: list[VolumeInfo]) -> tuple[list[VolumeInfo], list[VolumeInfo]]:
        """Full-state volume sync from one heartbeat.

        Layouts register BEFORE dn.volumes is replaced: an assign
        racing this sync reads free_space() from dn.volumes and
        writability from the layouts, and the old order (node map
        first) had a window where a full node counted against
        free_space while its volumes were not yet writable — a
        fresh-leader re-registration could answer "no free volumes
        left" for a perfectly healthy cluster. Registering layouts
        first errs the other way (at worst an unnecessary grow
        attempt, which is guarded), never a spurious hard failure."""
        for v in infos:
            self.id_gen.adjust_if_larger(v.id)
            self._layout_for(v).register_volume(v, dn)
        new, deleted = dn.update_volumes(infos)
        for v in deleted:
            self._layout_for(v).unregister_volume(v.id, dn)
        return new, deleted

    def delta_sync_volumes(
        self,
        dn: DataNode,
        new: list[VolumeInfo],
        deleted: list[VolumeInfo],
    ) -> None:
        """Incremental registration from a delta heartbeat
        (IncrementalSyncDataNodeRegistration role, master.proto:43-44):
        O(changes) instead of O(volumes) per beat."""
        for v in new:
            dn.volumes[v.id] = v
            self.id_gen.adjust_if_larger(v.id)
            self._layout_for(v).register_volume(v, dn)
        for v in deleted:
            dn.volumes.pop(v.id, None)
            self._layout_for(v).unregister_volume(v.id, dn)

    def _layout_for(self, v: VolumeInfo) -> VolumeLayout:
        rp = str(ReplicaPlacement.from_byte(v.replica_placement))
        ttl = str(TTL.from_uint32(v.ttl))
        return self.get_layout(v.collection, rp, ttl)

    def unregister_data_node(self, dn: DataNode) -> None:
        """Node lost (heartbeat stream broke, master_grpc_server.go:22,
        or declared dead by the master's liveness sweep)."""
        for v in dn.volumes.values():
            self._layout_for(v).unregister_volume(v.id, dn)
        for vid in list(dn.ec_shards):
            self.unregister_ec_shards(vid, dn)
        rack = dn.parent
        if rack is not None:
            rack.children.pop(dn.id, None)
        # detachment marker: a Heartbeat handler still holding this
        # object must re-register instead of mutating an orphan (whose
        # volumes would re-enter layouts referencing a detached node)
        dn.parent = None

    # --- scrub plane (docs/SCRUB.md) ---
    @staticmethod
    def sync_scrub_stats(dn: DataNode, infos: list) -> None:
        """Overwrite one node's scrub-health view from a heartbeat.
        Every beat carries the node's complete snapshot, so wholesale
        replacement is correct (rows for volumes the node no longer
        holds vanish with it)."""
        dn.scrub_stats = {(s.volume_id, s.is_ec): s for s in infos}

    def scrub_summary(self) -> dict:
        """Cluster-wide scrub rollup for status surfaces."""
        per_node: dict[str, dict] = {}
        for dn in self.data_nodes():
            stats = list(dn.scrub_stats.values())
            if not stats:
                continue
            per_node[dn.url] = {
                "Volumes": len(stats),
                "Corruptions": sum(s.corruptions_found for s in stats),
                "QuarantinedShards": sum(
                    bin(s.quarantined_shard_bits).count("1") for s in stats
                ),
                "ScannedBytes": sum(s.scanned_bytes for s in stats),
                "Errors": [
                    f"vid {s.volume_id}: {s.last_error}"
                    for s in stats
                    if s.last_error
                ][:10],
            }
        return per_node

    # --- EC shard registry (topology_ec.go) ---
    def sync_ec_shards(self, dn: DataNode, infos: list[EcShardInfo]) -> None:
        new_or_changed, deleted = dn.update_ec_shards(infos)
        for s in deleted:
            self.unregister_ec_shards(s.id, dn)
        for s in infos:
            self.register_ec_shards(s, dn)

    def register_ec_shards(self, info: EcShardInfo, dn: DataNode) -> None:
        with self._lock:
            locs = self.ec_shard_map.get(info.id)
            if locs is None:
                locs = EcShardLocations.empty(info.collection)
                self.ec_shard_map[info.id] = locs
            for shard_id in range(14):
                if info.ec_index_bits & (1 << shard_id):
                    if dn not in locs.locations[shard_id]:
                        locs.locations[shard_id].append(dn)
                elif dn in locs.locations[shard_id]:
                    # shard moved away from this node: drop the stale bit
                    locs.locations[shard_id].remove(dn)

    def unregister_ec_shards(self, vid: int, dn: DataNode) -> None:
        with self._lock:
            locs = self.ec_shard_map.get(vid)
            if locs is None:
                return
            for shard_list in locs.locations:
                if dn in shard_list:
                    shard_list.remove(dn)
            if all(not s for s in locs.locations):
                del self.ec_shard_map[vid]

    def lookup_ec_shards(self, vid: int) -> Optional[EcShardLocations]:
        return self.ec_shard_map.get(vid)

    # --- lookup / assign (topology.go:88-137) ---
    def lookup(self, collection: str, vid: int) -> list[DataNode]:
        with self._lock:
            if collection:
                keys = [k for k in self._layouts if k[0] == collection]
            else:
                keys = list(self._layouts)
        for key in keys:
            nodes = self._layouts[key].lookup(vid)
            if nodes:
                return nodes
        locs = self.lookup_ec_shards(vid)
        if locs is not None:
            nodes: list[DataNode] = []
            for shard_list in locs.locations:
                for dn in shard_list:
                    if dn not in nodes:
                        nodes.append(dn)
            return nodes
        return []

    def next_volume_id(self) -> int:
        return self.id_gen.next_volume_id()

    def has_writable_volume(self, collection: str, rp: str, ttl: str) -> bool:
        return self.get_layout(collection, rp, ttl).active_volume_count() > 0

    def pick_for_write(
        self,
        collection: str,
        rp: str,
        ttl: str,
        count: int = 1,
        data_center: str = "",
        policy: str = "p2c",
        health=None,
    ) -> tuple[int, int, list[DataNode]]:
        vid, nodes = self.get_layout(collection, rp, ttl).pick_for_write(
            data_center=data_center, policy=policy, health=health
        )
        return vid, count, nodes

    def find_empty_slots(
        self, rp: ReplicaPlacement, data_center: str = ""
    ) -> list[DataNode]:
        return volume_growth.find_empty_slots_for_one_volume(
            self, rp, data_center=data_center
        )

    @staticmethod
    def _volume_stat(v) -> dict:
        return {
            "Id": v.id,
            "Size": v.size,
            "Collection": v.collection,
            "FileCount": v.file_count,
            "DeleteCount": v.delete_count,
            "DeletedByteCount": v.deleted_byte_count,
            "ReadOnly": v.read_only,
            "Version": v.version,
            "ReplicaPlacement": v.replica_placement,
            "Ttl": v.ttl,
        }

    def to_volume_map(self) -> dict:
        """/vol/status shape (topology_map.go:30 ToVolumeMap): capacity
        totals plus dc -> rack -> node dicts of raw volume stats.

        Tree mutations happen under the MASTER's node lock (heartbeat
        delta sync, liveness sweeps), not self._lock, so this walk
        takes list() snapshots at every level — each is atomic under
        the GIL — instead of pretending a lock helps; a status dump may
        be a heartbeat out of date, never a RuntimeError."""
        dcs: dict = {}
        for dc in list(self.children.values()):
            racks: dict = {}
            for rack in list(dc.children.values()):
                nodes: dict = {}
                for dn in list(rack.children.values()):
                    nodes[dn.id] = [
                        self._volume_stat(v) for v in list(dn.volumes.values())
                    ]
                racks[rack.id] = nodes
            dcs[dc.id] = racks
        return {
            "Max": self.max_volume_count(),
            "Free": self.free_space(),
            "DataCenters": dcs,
        }

    def to_map(self) -> dict:
        """Status-UI topology dump (master_server_handlers_admin.go)."""
        return {
            "Max": self.max_volume_count(),
            "Free": self.free_space(),
            "DataCenters": [
                {
                    "Id": dc.id,
                    "Racks": [
                        {
                            "Id": rack.id,
                            "DataNodes": [
                                {
                                    "Url": dn.url,
                                    "PublicUrl": dn.public_url,
                                    "Volumes": dn.volume_count(),
                                    "EcShards": dn.ec_shard_count(),
                                    "Max": dn.max_volume_count(),
                                    # full per-volume detail so admin
                                    # planners (shell) can work from one
                                    # VolumeList call, like the
                                    # reference's TopologyInfo proto
                                    "VolumeInfos": [
                                        self._volume_stat(v)
                                        for v in list(dn.volumes.values())
                                    ],
                                    "EcShardInfos": [
                                        {
                                            "Id": s.id,
                                            "Collection": s.collection,
                                            "EcIndexBits": s.ec_index_bits,
                                        }
                                        for s in dn.ec_shards.values()
                                    ],
                                }
                                for dn in rack.children.values()  # type: ignore[attr-defined]
                            ],
                        }
                        for rack in dc.children.values()
                    ],
                }
                for dc in self.children.values()
            ],
        }
