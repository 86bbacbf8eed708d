"""weedtier: lifecycle tiering of cold EC volumes to object storage;
the port of seaweedfs_tpu/tier/.

Three pieces (docs/TIERING.md):

  * rules.py — the lifecycle policy: per-volume age + access
    temperature decide cold (tier out) vs hot (tier back in), with
    every threshold an env knob so operators tune without redeploys;
  * ec_tier.py — the volume-server engine: stream a sealed EC
    volume's shards to a configured `storage/backend`, publish the
    `.evf` attachment sidecar, and recall them with `.ecc` CRC
    verification on the way back;
  * scheduler.py — the master-side TierScheduler: leader-only scan
    over the EC registry, temperature fed from the telemetry rings,
    HTTP fan-out to the shard holders (every hop carries
    X-Weed-Deadline + X-Weed-Trace).

`WEED_TIER=0` disables the whole plane: the scheduler idles and the
volume servers refuse /tier/move — already-tiered volumes keep
serving (turning the switch off must never strand data remotely).
"""

from seaweedfs_tpu_torch.tier.rules import TierRules, tier_enabled
from seaweedfs_tpu_torch.tier.scheduler import TierScheduler

__all__ = ["TierRules", "TierScheduler", "tier_enabled"]
