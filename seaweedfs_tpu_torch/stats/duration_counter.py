"""Rolling per-interval request counters for status UIs.

Behavioral match of weed/stats/duration_counter.go: fixed-size rings of
per-second / per-minute / per-hour buckets whose sum gives "requests in
the last N"; the master/volume HTML UIs render these.
"""

from __future__ import annotations

import threading
import time


class _Ring:
    def __init__(self, slots: int, seconds_per_slot: float):
        self.slots = slots
        self.seconds_per_slot = seconds_per_slot
        self.counts = [0] * slots
        self.stamps = [0] * slots

    def add(self, now: float, amount: int) -> None:
        slot_id = int(now / self.seconds_per_slot)
        idx = slot_id % self.slots
        if self.stamps[idx] != slot_id:
            self.stamps[idx] = slot_id
            self.counts[idx] = 0
        self.counts[idx] += amount

    def total(self, now: float) -> int:
        slot_id = int(now / self.seconds_per_slot)
        return sum(
            c
            for c, s in zip(self.counts, self.stamps)
            if slot_id - s < self.slots
        )


class DurationCounter:
    def __init__(self):
        self._lock = threading.Lock()
        self._minute = _Ring(60, 1.0)       # last minute, per-second
        self._hour = _Ring(60, 60.0)        # last hour, per-minute
        self._day = _Ring(24, 3600.0)       # last day, per-hour
        self.total = 0

    def add(self, amount: int = 1, now: float | None = None) -> None:
        now = time.time() if now is None else now
        with self._lock:
            self.total += amount
            self._minute.add(now, amount)
            self._hour.add(now, amount)
            self._day.add(now, amount)

    def snapshot(self, now: float | None = None) -> dict:
        now = time.time() if now is None else now
        with self._lock:
            return {
                "total": self.total,
                "last_minute": self._minute.total(now),
                "last_hour": self._hour.total(now),
                "last_day": self._day.total(now),
            }
