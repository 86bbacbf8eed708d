"""Rack/DC-aware replica placement for new volumes.

Behavioral match of reference weed/topology/volume_growth.go: to place
one volume with replica placement "xyz" (x extra DCs, y extra racks,
z extra same-rack copies):

  1. pick a main DC (+x other DCs) whose rack/node structure can hold
     the full replica set (the nested possible-racks/nodes filter at
     volume_growth.go:100-120);
  2. inside the main DC, pick a main rack (+y other racks) with enough
     free nodes;
  3. inside the main rack, pick a main node (+z other nodes);
  4. one replica goes to each other DC/rack/node.

findVolumeCount: how many logical volumes one grow request creates
(7/6/3/1 for copy counts 1/2/3/more — volume_growth.go:50).
"""

from __future__ import annotations

import random

from seaweedfs_tpu_torch.storage.replica_placement import ReplicaPlacement
from seaweedfs_tpu_torch.topology.node import DataCenter, DataNode, Node, Rack


def find_volume_count(copy_count: int) -> int:
    return {1: 7, 2: 6, 3: 3}.get(copy_count, 1)


def find_empty_slots_for_one_volume(
    topo_root: Node,
    rp: ReplicaPlacement,
    data_center: str = "",
    rack: str = "",
    data_node: str = "",
    rng: random.Random | None = None,
) -> list[DataNode]:
    """Pick the replica node set for one new volume; raises ValueError
    when the topology cannot satisfy the placement."""
    rng = rng or random

    def dc_filter(node: Node):
        if data_center and node.id != data_center:
            return f"not preferred data center {data_center}"
        if len(node.children) < rp.diff_rack_count + 1:
            return f"only {len(node.children)} racks, need {rp.diff_rack_count + 1}"
        if node.free_space() < rp.diff_rack_count + rp.same_rack_count + 1:
            return f"free {node.free_space()} < {rp.diff_rack_count + rp.same_rack_count + 1}"
        possible_racks = sum(
            1
            for r in node.children.values()
            if sum(1 for n in r.children.values() if n.free_space() >= 1)
            >= rp.same_rack_count + 1
        )
        if possible_racks < rp.diff_rack_count + 1:
            return f"only {possible_racks} viable racks, need {rp.diff_rack_count + 1}"
        return None

    main_dc, other_dcs = topo_root.random_pick(
        rp.diff_data_center_count + 1, dc_filter, rng
    )

    def rack_filter(node: Node):
        if rack and node.id != rack:
            return f"not preferred rack {rack}"
        if node.free_space() < rp.same_rack_count + 1:
            return f"free {node.free_space()} < {rp.same_rack_count + 1}"
        viable = sum(1 for n in node.children.values() if n.free_space() >= 1)
        if viable < rp.same_rack_count + 1:
            return f"only {viable} free nodes, need {rp.same_rack_count + 1}"
        return None

    main_rack, other_racks = main_dc.random_pick(rp.diff_rack_count + 1, rack_filter, rng)

    def node_filter(node: Node):
        if data_node and node.id != data_node:
            return f"not preferred node {data_node}"
        if node.free_space() < 1:
            return "no free slot"
        return None

    main_node, other_nodes = main_rack.random_pick(
        rp.same_rack_count + 1, node_filter, rng
    )

    servers: list[DataNode] = [main_node]  # type: ignore[list-item]
    servers.extend(other_nodes)  # type: ignore[arg-type]
    for r in other_racks:
        n, _ = r.random_pick(1, node_filter, rng)
        servers.append(n)  # type: ignore[arg-type]
    for dc in other_dcs:
        assert isinstance(dc, DataCenter)
        candidate_racks = [
            r for r in dc.children.values() if any(
                n.free_space() >= 1 for n in r.children.values()
            )
        ]
        if not candidate_racks:
            raise ValueError(f"data center {dc.id} has no free node for a replica")
        r = rng.choice(candidate_racks)
        n, _ = r.random_pick(1, node_filter, rng)
        servers.append(n)  # type: ignore[arg-type]
    return servers
