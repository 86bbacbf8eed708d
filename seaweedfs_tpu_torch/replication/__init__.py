"""Filer-to-filer replication: the consumer that applies a filer's
update events to another filer, a local directory, an S3 bucket or a
GCS, Azure or B2 bucket (weed/replication/). The port of
seaweedfs_tpu/replication/; the cloud sinks are in cloud_sinks.py."""

from seaweedfs_tpu_torch.replication.replicator import Replicator

__all__ = ["Replicator"]
