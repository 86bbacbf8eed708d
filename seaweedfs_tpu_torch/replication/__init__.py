"""Filer-to-filer replication: the consumer that applies a filer's
update events to another filer, a local directory or an S3 bucket
(weed/replication/). The port of seaweedfs_tpu/replication/; the cloud
sinks (GCS, Azure, B2) are ROADMAP item 12b."""

from seaweedfs_tpu_torch.replication.replicator import Replicator

__all__ = ["Replicator"]
