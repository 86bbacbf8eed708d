"""Persisted scrub state: per-volume cursor + health, one JSON file
per disk location.

Restart-resumability is the point: a 30 GB volume at a 64 MB/s scrub
rate takes ~8 minutes to sweep; a volume server restart mid-sweep must
resume at the cursor, not start over (or worse, never finish under a
restart-heavy deploy cadence). Writes are atomic (tmp + rename) so a
crash can't leave a torn state file.
"""

from __future__ import annotations

import json
import os
import threading
from dataclasses import asdict, dataclass, field

from seaweedfs_tpu_torch.util import durable


@dataclass
class VolumeScrubHealth:
    """One volume's scrub-plane record (the ScrubStat heartbeat row
    plus the resume cursor, which stays local)."""

    volume_id: int
    is_ec: bool = False
    # plain volumes: last verified needle id; EC volumes: byte offset
    # into the shard the next sweep resumes at
    cursor: int = 0
    last_sweep_unix: float = 0.0
    scanned_bytes: int = 0  # cumulative across sweeps
    corruptions_found: int = 0  # cumulative (metrics/status surface)
    # corruption events as of the most recent COMPLETED sweep pass —
    # this is what heartbeats report, so a repaired volume's next clean
    # pass drops the row to 0 and the master's repair scheduler
    # converges instead of re-repairing on stale history. New finds
    # mid-pass ADD immediately (damage must reach the master now); the
    # value only ever drops when a full pass finishes, so a still-
    # corrupt volume never reads as clean mid-sweep (which would reset
    # the scheduler's backoff state every sweep).
    sweep_corruptions: int = 0
    # finds within the in-progress pass (becomes sweep_corruptions at
    # pass completion); persisted so a restart mid-pass keeps counting
    pass_corruptions: int = 0
    sweeps: int = 0
    last_error: str = ""
    # .ecc sidecar sweep cursor triple (scrub/verify.verify_ecc_stream):
    # shard being read, byte offset within it, and the RUNNING CRC-32C
    # at that offset — persisting the running CRC lets a restart resume
    # mid-shard instead of reverifying from byte 0. Independent of
    # `cursor` (the parity-path offset): a volume can flip between the
    # two paths mid-life when its sidecar appears/goes stale.
    ecc_shard: int = 0
    ecc_offset: int = 0
    ecc_crc: int = 0

    def to_dict(self) -> dict:
        return asdict(self)

    @classmethod
    def from_dict(cls, d: dict) -> "VolumeScrubHealth":
        known = {f for f in cls.__dataclass_fields__}  # noqa: C416
        return cls(**{k: v for k, v in d.items() if k in known})


@dataclass
class ScrubState:
    path: str
    volumes: dict[tuple[int, bool], VolumeScrubHealth] = field(
        default_factory=dict
    )

    def __post_init__(self) -> None:
        self._lock = threading.Lock()
        self.load()

    def load(self) -> None:
        try:
            with open(self.path, "r", encoding="utf-8") as f:
                raw = json.load(f)
        except (OSError, ValueError):
            return
        # same lock as get/forget/save: load() is construction-time
        # today, but it is a public method on a table that heartbeat
        # and engine threads read — keep the guard discipline uniform
        with self._lock:
            for d in raw.get("volumes", []):
                try:
                    h = VolumeScrubHealth.from_dict(d)
                except TypeError:
                    continue  # unknown/legacy row: start that volume fresh
                self.volumes[(h.volume_id, h.is_ec)] = h

    def get(self, volume_id: int, is_ec: bool) -> VolumeScrubHealth:
        with self._lock:
            key = (volume_id, is_ec)
            h = self.volumes.get(key)
            if h is None:
                h = self.volumes[key] = VolumeScrubHealth(
                    volume_id=volume_id, is_ec=is_ec
                )
            return h

    def forget(self, volume_id: int, is_ec: bool) -> None:
        with self._lock:
            self.volumes.pop((volume_id, is_ec), None)

    def save(self) -> None:
        with self._lock:
            payload = {
                "volumes": [h.to_dict() for h in self.volumes.values()]
            }
        tmp = self.path + ".tmp"
        try:
            with open(tmp, "w", encoding="utf-8") as f:
                json.dump(payload, f)
            # fsync + rename + dir fsync: the cursor file is the first
            # thing restart recovery reads — a torn or lost publish
            # would restart every in-flight sweep from zero (or worse,
            # parse-fail and reset health history)
            durable.publish(tmp, self.path)
        except OSError:
            # a disk too sick to persist scrub state is a disk the
            # sweep itself will report on; never crash the engine here
            try:
                os.remove(tmp)
            except OSError:
                pass
