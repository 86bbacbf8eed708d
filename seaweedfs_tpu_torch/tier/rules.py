"""Lifecycle rules: when is an EC volume cold enough to tier out, and
when is a tiered one hot enough to recall?

Two signals per volume:

  * age — seconds since the newest shard file's mtime on its holder
    (EC volumes are sealed at encode time, so shard mtime IS the seal
    time; a rebuild refreshes it, which conveniently also restarts
    the cold clock on a volume the repair plane just touched);
  * temperature — the read rate the telemetry plane observed for the
    volume (`weed_volume_read_total` summed across holders over the
    collector window). With telemetry off the rate reads 0.0, i.e.
    cold — age alone then gates tiering, which is the conservative
    failure mode (an untelemetered cluster still tiers, and recall is
    driven by the holders' own counters when the collector returns).

Hysteresis: the recall threshold sits above the tier-out threshold so
a volume flapping around one rate doesn't ping-pong shards through
the backend.
"""

from __future__ import annotations

import os
from dataclasses import dataclass


def tier_enabled() -> bool:
    """`WEED_TIER=0` kills the tiering plane wholesale: the scheduler
    idles and /tier/move refuses. Already-tiered volumes keep serving
    (disabling the plane must never strand data remotely)."""
    return os.environ.get("WEED_TIER", "1") != "0"


def _float(raw: str | None, default: float) -> float:
    # callers pass os.environ.get("WEED_...") inline so the weedlint
    # contract-env rule can see which knob each read belongs to
    try:
        return float(raw or default)
    except ValueError:
        return default


@dataclass
class TierRules:
    """The policy knobs, env-overridable (OPERATIONS.md):

    WEED_TIER_BACKEND      destination backend name ("type.id"); empty
                           disables the scheduler (no destination)
    WEED_TIER_MIN_AGE_S    a volume younger than this never tiers out
    WEED_TIER_COLD_RPS     read rate at/below which a volume is cold
    WEED_TIER_HOT_RPS      read rate above which a tiered volume is
                           recalled (> COLD_RPS for hysteresis)
    """

    backend: str = ""
    min_age_s: float = 3600.0
    cold_reads_per_s: float = 0.05
    hot_reads_per_s: float = 1.0

    @classmethod
    def from_env(cls) -> "TierRules":
        return cls(
            backend=os.environ.get("WEED_TIER_BACKEND", ""),
            min_age_s=_float(os.environ.get("WEED_TIER_MIN_AGE_S"), 3600.0),
            cold_reads_per_s=_float(os.environ.get("WEED_TIER_COLD_RPS"), 0.05),
            hot_reads_per_s=_float(os.environ.get("WEED_TIER_HOT_RPS"), 1.0),
        )

    def decide(
        self, age_s: float, reads_per_s: float, tiered: bool
    ) -> str | None:
        """"out", "in", or None (leave it where it is)."""
        if tiered:
            if reads_per_s > self.hot_reads_per_s:
                return "in"
            return None
        if age_s >= self.min_age_s and reads_per_s <= self.cold_reads_per_s:
            return "out"
        return None

    def to_dict(self) -> dict:
        return {
            "Backend": self.backend,
            "MinAgeSeconds": self.min_age_s,
            "ColdReadsPerSec": self.cold_reads_per_s,
            "HotReadsPerSec": self.hot_reads_per_s,
        }
