"""Scrub & self-healing plane; the port of seaweedfs_tpu/scrub/.

Background integrity sweeps on every volume server, scrub/quarantine
health flowing to the master over the heartbeat stream, and a
master-side repair scheduler that turns detected damage into
VolumeEcShardsRebuild / re-replication work with a global concurrency
cap and per-volume backoff.

  arbiter    — process-wide bandwidth arbiter of the background planes
  ratelimit  — token bucket bounding scrub disk+network bandwidth
  state      — per-disk-location persisted cursors + health records
  verify     — parity re-verify / reconstruct-compare / needle CRC walk
               (the EC re-encodes and localization decodes run through
               the caller's codec: K1 on the card)
  engine     — the volume-server background sweeper (ScrubEngine)
  repair     — the master-side repair scheduler (RepairScheduler)
"""

from seaweedfs_tpu_torch.scrub.engine import ScrubEngine
from seaweedfs_tpu_torch.scrub.ratelimit import TokenBucket
from seaweedfs_tpu_torch.scrub.repair import RepairScheduler
from seaweedfs_tpu_torch.scrub.state import ScrubState, VolumeScrubHealth

__all__ = [
    "ScrubEngine",
    "RepairScheduler",
    "ScrubState",
    "TokenBucket",
    "VolumeScrubHealth",
]
