"""Metrics: the Prometheus-style registry the port's modules count into,
the pushgateway loop and the master's rolling request counters."""
from seaweedfs_tpu_torch.stats.metrics import (
    Counter,
    Gauge,
    Histogram,
    Registry,
    DEFAULT_REGISTRY,
    start_push_loop,
)
from seaweedfs_tpu_torch.stats.duration_counter import DurationCounter

__all__ = [
    "Counter",
    "Gauge",
    "Histogram",
    "Registry",
    "DEFAULT_REGISTRY",
    "DurationCounter",
    "start_push_loop",
]
