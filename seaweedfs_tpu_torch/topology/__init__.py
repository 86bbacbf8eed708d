"""Cluster control plane: the master's view of the world.

DC → rack → data-node tree with capacity accounting, per-(collection,
rp, ttl) volume layouts, rack-aware replica placement, the EC shard
registry, and the file-id sequencer — the logic behind /dir/assign,
/dir/lookup and heartbeat processing (reference weed/topology/,
SURVEY.md §2.2)."""

from seaweedfs_tpu_torch.topology.topology import Topology  # noqa: F401
from seaweedfs_tpu_torch.topology.node import DataNode  # noqa: F401
