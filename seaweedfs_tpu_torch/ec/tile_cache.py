"""Per-volume LRU cache of reconstructed EC shard tiles (the port of
seaweedfs_tpu/ec/tile_cache.py, same knobs and behavior).

A degraded read — a GET whose interval lands on a lost/quarantined
shard — must decode that interval from k surviving shards. The decode
input is k× the output and the gather usually crosses the rack, so
re-decoding the same hot range for every GET multiplies both CPU and
network by the read rate. This cache remembers the *reconstructed
bytes* at fixed tile granularity: the first degraded read of a tile
pays the k-shard gather + decode once, every later read of any
interval inside it is a memcpy.

Correctness leans on two facts:

  * RS reconstruction is deterministic — any k survivors produce the
    same bytes — so a cached tile is byte-identical to a fresh decode
    no matter which survivor set either used;
  * shard bytes are immutable while mounted (deletes tombstone the
    .ecx, never touch shard files), so the only events that can change
    what a decode would return are shard remount (a rebuild landed a
    regenerated file), quarantine, and rebuild itself — EcVolume
    invalidates on each.

Scan resistance (segmented admission): a sequential scan through a
dead shard touches every tile exactly once; in a plain LRU those
one-touch tiles march straight through and evict the hot set. Tiles
therefore land in a small PROBATION segment first (bounded at
capacity/8, min one tile) and are only promoted to the protected
segment on a second touch — a get() hit while still probationary.
Scans churn probation only; eviction under global pressure drains
probation before it ever considers a protected tile.
WEED_EC_TILE_SCAN=0 restores the plain single-segment LRU wholesale.

The cache is per-EcVolume (dropped wholesale with the volume), bounded
in bytes, and safe for concurrent readers. Knobs (the reference's
OPERATIONS.md env table): WEED_EC_TILE_CACHE=0 disables, WEED_EC_TILE_CACHE_MB
bounds the per-volume footprint (default 64), WEED_EC_TILE_BYTES sets
the tile granularity (default 256 KiB), WEED_EC_TILE_SCAN=0 disables
the probationary segment.
"""

from __future__ import annotations

import os
import threading
from collections import OrderedDict

from seaweedfs_tpu_torch.stats.metrics import EC_TILE_CACHE

DEFAULT_TILE_BYTES = 256 * 1024
DEFAULT_CAPACITY_MB = 64


def _int_or(raw: str, default: int) -> int:
    try:
        return int(raw)
    except ValueError:
        return default


class TileCache:
    """Segmented LRU of (shard_id, tile_offset) -> reconstructed bytes:
    probation (one-touch, scan-churned) + protected (second-touch)."""

    def __init__(
        self,
        capacity_bytes: int | None = None,
        tile_bytes: int | None = None,
    ):
        # literal env reads, one per knob, as the reference reads them
        if capacity_bytes is None:
            capacity_bytes = _int_or(
                os.environ.get(
                    "WEED_EC_TILE_CACHE_MB", str(DEFAULT_CAPACITY_MB)
                ),
                DEFAULT_CAPACITY_MB,
            ) << 20
        if tile_bytes is None:
            tile_bytes = _int_or(
                os.environ.get(
                    "WEED_EC_TILE_BYTES", str(DEFAULT_TILE_BYTES)
                ),
                DEFAULT_TILE_BYTES,
            )
        self.capacity_bytes = max(0, capacity_bytes)
        self.tile_bytes = max(4096, tile_bytes)
        if os.environ.get("WEED_EC_TILE_CACHE", "1") == "0":
            self.capacity_bytes = 0
        self.scan_resistant = (
            os.environ.get("WEED_EC_TILE_SCAN", "1") != "0"
        )
        # probation stays SMALL: a scan can only ever churn this much
        self.probation_bytes_cap = min(
            self.capacity_bytes,
            max(self.tile_bytes, self.capacity_bytes // 8),
        )
        self._lock = threading.Lock()
        self._probation: OrderedDict[tuple[int, int], bytes] = OrderedDict()
        self._protected: OrderedDict[tuple[int, int], bytes] = OrderedDict()
        self._prob_bytes = 0
        self._prot_bytes = 0
        self.invalidations = 0

    @property
    def enabled(self) -> bool:
        return self.capacity_bytes > 0

    @property
    def total_bytes(self) -> int:
        with self._lock:
            return self._prob_bytes + self._prot_bytes

    def _evict_over_bounds(self) -> None:
        """Lock held. Probation to its own cap, then the global bound —
        probation drains first, protected only under residual
        pressure (how a scan never touches the hot set)."""
        while self._prob_bytes > self.probation_bytes_cap and self._probation:
            _, v = self._probation.popitem(last=False)
            self._prob_bytes -= len(v)
        while (
            self._prob_bytes + self._prot_bytes > self.capacity_bytes
        ) and (self._probation or self._protected):
            if self._probation:
                _, v = self._probation.popitem(last=False)
                self._prob_bytes -= len(v)
            else:
                _, v = self._protected.popitem(last=False)
                self._prot_bytes -= len(v)

    def get(self, shard_id: int, tile_off: int) -> bytes | None:
        """Counted probe (hit/miss land on weed_ec_tile_cache_total).
        A probationary hit is the second touch: the tile promotes to
        the protected segment."""
        key = (shard_id, tile_off)
        with self._lock:
            data = self._protected.get(key)
            if data is not None:
                self._protected.move_to_end(key)
            else:
                data = self._probation.get(key)
                if data is not None:
                    # second touch: promote
                    del self._probation[key]
                    self._prob_bytes -= len(data)
                    self._protected[key] = data
                    self._prot_bytes += len(data)
                    self._evict_over_bounds()
        EC_TILE_CACHE.labels("hit" if data is not None else "miss").inc()
        return data

    def covers(self, shard_id: int, offset: int, size: int) -> bool:
        """Uncounted probe: True when every tile of [offset, offset+size)
        is resident — lets the read path prefer memory over a remote
        shard fetch without charging a miss for merely asking."""
        if not self.enabled or size <= 0:
            return False
        tile = self.tile_bytes
        t = (offset // tile) * tile
        with self._lock:
            while t < offset + size:
                data = self._protected.get((shard_id, t))
                if data is None:
                    data = self._probation.get((shard_id, t))
                if data is None or t + len(data) < min(offset + size, t + tile):
                    return False
                t += tile
        return True

    def put(
        self,
        shard_id: int,
        tile_off: int,
        data: bytes,
        gen: int | None = None,
    ) -> bool:
        """Insert a tile; returns True when it landed. `gen` is the
        invalidation generation captured BEFORE the decode started
        (self.invalidations): an invalidation that raced the decode —
        e.g. a survivor quarantined mid-gather may have contributed
        corrupt bytes — makes the stale insert a no-op instead of
        poisoning the cache forever (checked under the same lock
        invalidate() increments under).

        New tiles are admitted to PROBATION (or straight to the single
        segment with WEED_EC_TILE_SCAN=0); a re-put of an already
        protected tile updates it in place."""
        if not self.enabled or not data:
            return False
        key = (shard_id, tile_off)
        with self._lock:
            if gen is not None and gen != self.invalidations:
                return False
            old = self._protected.pop(key, None)
            if old is not None:
                # already earned protection: refresh in place
                self._prot_bytes -= len(old)
                self._protected[key] = data
                self._prot_bytes += len(data)
                self._evict_over_bounds()
                return True
            old = self._probation.pop(key, None)
            if old is not None:
                self._prob_bytes -= len(old)
            if self.scan_resistant:
                self._probation[key] = data
                self._prob_bytes += len(data)
            else:
                self._protected[key] = data
                self._prot_bytes += len(data)
            self._evict_over_bounds()
        return True

    def snapshot(self, shard_id: int) -> list[tuple[int, bytes]]:
        """Resident tiles of one shard, (tile_off, bytes) — the rebuild
        piggyback drains these at session open so degraded traffic that
        already ran still counts toward repair forward-progress.
        Probationary tiles count too: their bytes are just as decoded."""
        with self._lock:
            out = [
                (off, data)
                for (sid, off), data in self._protected.items()
                if sid == shard_id
            ]
            out += [
                (off, data)
                for (sid, off), data in self._probation.items()
                if sid == shard_id
            ]
            return out

    def invalidate(self) -> None:
        """Drop everything (shard remount / quarantine / rebuild: the
        decode inputs changed, cached outputs may no longer match)."""
        with self._lock:
            self._probation.clear()
            self._protected.clear()
            self._prob_bytes = 0
            self._prot_bytes = 0
            self.invalidations += 1
