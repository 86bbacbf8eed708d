"""The cluster tier: raft among masters (raft.py) and the node-health
plane (health.py: the master's phi-accrual scoring and the volume
server's disk watchdog)."""

from seaweedfs_tpu_torch.cluster.raft import RaftNode  # noqa: F401
