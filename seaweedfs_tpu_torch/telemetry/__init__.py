"""The sampling profiler every daemon runs (profiler.py). The cluster
telemetry plane of seaweedfs_tpu/telemetry/ (scraper, ring TSDB,
alerts, capsules) is not part of the port yet."""
