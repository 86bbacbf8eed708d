"""Counters the EC pipelines and the degraded read path bump: the part of
seaweedfs_tpu/stats/metrics.py that ec_stream, ec_files, ec_volume,
tile_cache and repair_session touch, under the same metric names.

A Counter holds one float per label tuple; `labels(...)` returns a
child bound to one tuple and `value(...)` reads it. Prometheus
rendering and the registry of the reference are not part of the port.
"""

from __future__ import annotations

import threading


class Counter:
    def __init__(self, name: str, help_: str, label_names: tuple[str, ...] = ()):
        self.name = name
        self.help = help_
        self.label_names = label_names
        self._values: dict[tuple[str, ...], float] = {}
        self._lock = threading.Lock()

    def labels(self, *label_values: str) -> "_CounterChild":
        return _CounterChild(self, tuple(label_values))

    def inc(self, amount: float = 1.0) -> None:
        self._add((), amount)

    def value(self, *label_values: str) -> float:
        return self._values.get(tuple(label_values), 0.0)

    def _add(self, key: tuple[str, ...], amount: float) -> None:
        with self._lock:
            self._values[key] = self._values.get(key, 0.0) + amount


class _CounterChild:
    def __init__(self, parent: Counter, key: tuple[str, ...]):
        self._parent = parent
        self._key = key

    def inc(self, amount: float = 1.0) -> None:
        self._parent._add(self._key, amount)


# --- EC degraded reads & repair-bandwidth accounting ------------------------
EC_DEGRADED_READS = Counter(
    "weed_ec_degraded_read_total",
    "EC intervals served by reconstruction (a shard was lost/quarantined)",
)
EC_TILE_CACHE = Counter(
    "weed_ec_tile_cache_total",
    "reconstructed-tile cache probes on the degraded read path",
    ("result",),  # result: hit | miss
)
EC_REPAIR_BYTES_READ = Counter(
    "weed_ec_repair_bytes_read_total",
    "survivor bytes gathered by EC rebuild, by where they came from",
    ("source",),  # source: local | remote
)
EC_REPAIR_BYTES_WRITTEN = Counter(
    "weed_ec_repair_bytes_written_total",
    "rebuilt shard bytes written by EC rebuild",
)
EC_REPAIR_DONATED_BYTES = Counter(
    "weed_ec_repair_donated_bytes_total",
    "tile bytes degraded serving handed to an in-progress rebuild",
)
