"""Shell command environment.

Behavioral match of weed/shell/commands.go CommandEnv: holds the master
address, fetches the topology (one VolumeList call feeds every
planner), and opens master and volume-server gRPC channels on demand.

The port of seaweedfs_tpu/shell/command_env.py. The fs.* context (the
selected filer and working directory) waits for ROADMAP item 11, with
the fs.* verbs that read it.
"""

from __future__ import annotations

import json
from dataclasses import dataclass, field

import grpc

from seaweedfs_tpu_torch.pb import master_pb2, rpc
from seaweedfs_tpu_torch.pb.rpc import grpc_address


@dataclass
class TopologyNodeInfo:
    """One data node as seen in the master's VolumeList dump."""

    url: str
    public_url: str
    dc: str
    rack: str
    max_volumes: int
    volumes: list[dict] = field(default_factory=list)
    ec_shards: list[dict] = field(default_factory=list)  # {Id, Collection, EcIndexBits}


@dataclass
class TopologyDump:
    volume_size_limit_mb: int
    nodes: list[TopologyNodeInfo] = field(default_factory=list)


class CommandEnv:
    def __init__(self, masters: list[str]):
        self.masters = list(masters)

    @property
    def master(self) -> str:
        return self.masters[0]

    def master_channel(self) -> grpc.Channel:
        return rpc.dial(grpc_address(self.master))

    def volume_channel(self, url: str) -> grpc.Channel:
        return rpc.dial(grpc_address(url))

    def collect_topology(self) -> TopologyDump:
        """VolumeList → parsed per-node volume/EC info (the one call
        every planner starts from, command_ec_common.go collectEcNodes)."""
        with self.master_channel() as ch:
            resp = rpc.master_stub(ch).VolumeList(master_pb2.VolumeListRequest())
        topo = json.loads(resp.topology_json)
        dump = TopologyDump(volume_size_limit_mb=resp.volume_size_limit_mb)
        for dc in topo.get("DataCenters", []):
            for rack in dc.get("Racks", []):
                for dn in rack.get("DataNodes", []):
                    dump.nodes.append(
                        TopologyNodeInfo(
                            url=dn["Url"],
                            public_url=dn.get("PublicUrl", dn["Url"]),
                            dc=dc["Id"],
                            rack=rack["Id"],
                            max_volumes=dn.get("Max", 0),
                            volumes=dn.get("VolumeInfos", []),
                            ec_shards=dn.get("EcShardInfos", []),
                        )
                    )
        return dump
