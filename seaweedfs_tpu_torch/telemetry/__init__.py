"""Cluster telemetry plane (docs/TELEMETRY.md).

Every request carries a trace; this plane makes the CLUSTER visible:

  parse.py     Prometheus text-format 0.0.4 parser (the wire format
               every daemon's /metrics already speaks)
  ring.py      fixed-retention in-process ring TSDB: per-series sample
               rings with counter-reset-aware rate/increase and
               histogram-bucket quantiles
  collector.py leader-only master scraper: volume servers discovered
               from heartbeats, gateways via /cluster/register, with
               per-target staleness + last-error tracking
  alerts.py    SLO alert rules with firing→resolved transitions,
               re-exported as weed_alert_firing gauges
  slo.py       multi-window burn-rate SLO engine, one objective per
               plane (serve, scrub, repair, tier)
  capsule.py   incident capsules: durable snapshots of a node's
               evidence, captured when an alert fires or on demand
  profiler.py  continuous sampling profiler on every daemon
               (sys._current_frames() → folded stacks, /debug/profile)
  announce.py  gateway → master registration heartbeats
  weedload.py  multi-process closed-loop load harness with
               coordinated-omission-safe log-bucketed histograms

The aggregation-only design follows the reference's shape
(weed/stats/metrics.go push loop + weed/shell cluster commands) and the
Facebook warehouse study (arXiv:1309.0186): fleet-level interference —
repair traffic stealing serving bandwidth, one slow node dragging the
cluster p99.9 — is only visible in aggregated telemetry, never in any
single daemon's counters.

The port of seaweedfs_tpu/telemetry/. The background planes it holds
to their own objectives run on the card here: scrub sweeps re-encode
with K1, repairs rebuild with K1 and K4, and degraded GETs decode with
K1 and K5, each under its `plane` label. The collector's stop() joins
its thread and the capsule captures it launched.
"""

from seaweedfs_tpu_torch.telemetry.alerts import AlertManager, AlertRule
from seaweedfs_tpu_torch.telemetry.collector import ClusterCollector
from seaweedfs_tpu_torch.telemetry.parse import parse_prometheus_text
from seaweedfs_tpu_torch.telemetry.ring import SeriesRing, TargetStore

__all__ = [
    "AlertManager",
    "AlertRule",
    "ClusterCollector",
    "SeriesRing",
    "TargetStore",
    "parse_prometheus_text",
]
