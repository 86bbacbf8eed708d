"""Shell command environment.

Behavioral match of weed/shell/commands.go CommandEnv: holds the master
address, fetches the topology (one VolumeList call feeds every
planner), and opens master and volume-server gRPC channels on demand.

The port of seaweedfs_tpu/shell/command_env.py, with the fs.* context:
the selected filer and working directory the fs.* verbs resolve paths
against.
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
        # fs.* context (commands.go CommandEnv option.FilerHost/directory):
        # set by `fs.cd http://<filer>:<port>/path`; subsequent relative
        # fs paths resolve against (filer, cwd)
        self.filer: str = ""
        self.cwd: str = "/"

    @property
    def master(self) -> str:
        return self.masters[0]

    def master_channel(self) -> grpc.Channel:
        return rpc.dial(grpc_address(self.master))

    def volume_channel(self, url: str) -> grpc.Channel:
        return rpc.dial(grpc_address(url))

    # ------------------------------------------------------------------
    # fs path resolution (commandEnv.parseUrl, commands.go:54-113)
    def parse_fs_path(self, input_path: str) -> tuple[str, str]:
        """'http://filer:8888/a/b' | '/a/b' | 'b' → (filer, abs path)."""
        import posixpath
        import urllib.parse

        if input_path.startswith(("http://", "https://")):
            u = urllib.parse.urlparse(input_path)
            return u.netloc, posixpath.normpath(u.path or "/")
        if not self.filer:
            raise ValueError(
                "no filer selected; use fs.cd http://<filer>:<port>/path first"
            )
        if input_path.startswith("/"):
            return self.filer, posixpath.normpath(input_path)
        return self.filer, posixpath.normpath(
            posixpath.join(self.cwd, input_path)
        )

    def filer_channel(self, filer: str) -> grpc.Channel:
        return rpc.dial(grpc_address(filer))

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
