"""The DC → rack → data-node tree with aggregated capacity counts.

Behavioral match of reference weed/topology/node.go, data_center.go,
rack.go, data_node.go: each level aggregates volume counts, max-volume
capacity and EC shard counts from its children; placement walks pick
random children subject to a filter (RandomlyPickNodes). The reference
spreads this over an interface + embedded struct; here it is one small
class hierarchy.
"""

from __future__ import annotations

import random
from typing import Callable, Optional

from seaweedfs_tpu_torch.storage.store import EcShardInfo, ScrubStatInfo, VolumeInfo


class Node:
    def __init__(self, node_id: str):
        self.id = node_id
        self.children: dict[str, "Node"] = {}
        self.parent: Optional["Node"] = None

    # --- capacity aggregation ---
    def max_volume_count(self) -> int:
        return sum(c.max_volume_count() for c in self.children.values())

    def volume_count(self) -> int:
        return sum(c.volume_count() for c in self.children.values())

    def ec_shard_count(self) -> int:
        return sum(c.ec_shard_count() for c in self.children.values())

    def free_space(self) -> int:
        """Free volume slots, with EC shards charged fractionally
        (reference data_node_ec.go: each 14-shard set ≈ one volume)."""
        return (
            self.max_volume_count()
            - self.volume_count()
            - self.ec_shard_count() // 14
        )

    def get_or_create(self, child_id: str, factory) -> "Node":
        child = self.children.get(child_id)
        if child is None:
            child = factory(child_id)
            child.parent = self
            self.children[child_id] = child
        return child

    def random_pick(
        self,
        count: int,
        filter_fn: Callable[["Node"], Optional[str]],
        rng: random.Random | None = None,
    ) -> tuple["Node", list["Node"]]:
        """Pick 1 main + (count-1) other children passing `filter_fn`
        (which returns an error string or None), reservoir-style
        (node.go RandomlyPickNodes). Raises ValueError if not enough."""
        rng = rng or random
        candidates = []
        errs = []
        for node in self.children.values():
            err = filter_fn(node)
            if err is None:
                candidates.append(node)
            else:
                errs.append(f"{node.id}: {err}")
        if len(candidates) < count:
            raise ValueError(
                f"only {len(candidates)} of {count} candidates at {self.id or 'root'}: "
                + "; ".join(errs[:5])
            )
        picked = rng.sample(candidates, count)
        return picked[0], picked[1:]


class DataNode(Node):
    """One volume-server process (data_node.go)."""

    def __init__(self, node_id: str, ip: str = "", port: int = 0, public_url: str = "", max_volumes: int = 7):
        super().__init__(node_id)
        self.ip = ip
        self.port = port
        self.public_url = public_url or (f"{ip}:{port}" if ip else node_id)
        self._max_volumes = max_volumes
        self.volumes: dict[int, VolumeInfo] = {}
        self.ec_shards: dict[int, EcShardInfo] = {}  # vid -> shard bits
        # scrub plane: (vid, is_ec) -> latest ScrubStat row from this
        # node's heartbeats; the repair scheduler reads corruption and
        # quarantine signals from here
        self.scrub_stats: dict[tuple[int, bool], ScrubStatInfo] = {}
        # QoS plane (docs/QOS.md): live load from the node's heartbeats
        # — in-flight HTTP dispatches and group-commit queue depth;
        # pick_for_write's power-of-two-choices weighs nodes by these
        self.in_flight = 0
        self.write_queue_depth = 0
        self.last_seen = 0.0

    @property
    def url(self) -> str:
        return f"{self.ip}:{self.port}" if self.ip else self.id

    def queue_load(self) -> int:
        """The node's reported live load — what queue-depth-aware
        assignment compares (heartbeat-fresh, so at most one beat
        stale; ties break random in the layout's picker)."""
        return self.in_flight + self.write_queue_depth

    def max_volume_count(self) -> int:
        return self._max_volumes

    def volume_count(self) -> int:
        return len(self.volumes)

    def ec_shard_count(self) -> int:
        return sum(bin(s.ec_index_bits).count("1") for s in self.ec_shards.values())

    def update_volumes(self, infos: list[VolumeInfo]) -> tuple[list[VolumeInfo], list[VolumeInfo]]:
        """Full-state sync; returns (new, deleted) volume infos."""
        incoming = {v.id: v for v in infos}
        new = [v for vid, v in incoming.items() if vid not in self.volumes]
        deleted = [v for vid, v in self.volumes.items() if vid not in incoming]
        self.volumes = incoming
        return new, deleted

    def update_ec_shards(self, infos: list[EcShardInfo]) -> tuple[list[EcShardInfo], list[EcShardInfo]]:
        incoming = {s.id: s for s in infos}
        new_or_changed = [
            s
            for vid, s in incoming.items()
            if vid not in self.ec_shards or self.ec_shards[vid].ec_index_bits != s.ec_index_bits
        ]
        deleted = [s for vid, s in self.ec_shards.items() if vid not in incoming]
        self.ec_shards = incoming
        return new_or_changed, deleted

    def get_rack(self) -> "Rack":
        assert isinstance(self.parent, Rack)
        return self.parent

    def get_data_center(self) -> "DataCenter":
        return self.get_rack().get_data_center()


class Rack(Node):
    def new_data_node(self, node_id: str, **kw) -> DataNode:
        node = self.children.get(node_id)
        if node is None:
            node = DataNode(node_id, **kw)
            node.parent = self
            self.children[node_id] = node
        return node  # type: ignore[return-value]

    def get_data_center(self) -> "DataCenter":
        assert isinstance(self.parent, DataCenter)
        return self.parent


class DataCenter(Node):
    def get_or_create_rack(self, rack_id: str) -> Rack:
        return self.get_or_create(rack_id, Rack)  # type: ignore[return-value]
