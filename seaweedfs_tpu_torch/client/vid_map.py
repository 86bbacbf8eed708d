"""Client-side volume-id → locations map.

Behavioral match of the reference's wdclient vidMap
(weed/wdclient/vid_map.go): thread-safe map updated from the master's
KeepConnected push stream, with round-robin pick over replicas — plus
a tiny circuit breaker (QoS plane, docs/QOS.md): replicas with a
recent connection error are demoted to the end of the candidate list
for a short TTL, so a dead node costs one timeout per TTL instead of
one per lookup.

The port of seaweedfs_tpu/client/vid_map.py.
"""

from __future__ import annotations

import itertools
import os
import threading
import time
from dataclasses import dataclass


@dataclass(frozen=True)
class Location:
    url: str
    public_url: str


# ----------------------------------------------------------------------
# replica circuit breaker — shared module-level registry so every
# consumer of replica lists (VidMap round-robin, hedged reads,
# filer chunk reads) sees the same health view in one process
_breaker_lock = threading.Lock()
_broken_until: dict[str, float] = {}


def _breaker_ttl_s() -> float:
    """How long one connection error demotes a replica
    (WEED_QOS_BREAKER_TTL_S, default 5 s; 0 disables)."""
    try:
        return float(os.environ.get("WEED_QOS_BREAKER_TTL_S", "5"))
    except ValueError:
        return 5.0


def note_failure(url: str, now: float | None = None) -> None:
    """Record a connection error against `url` ("host:port")."""
    ttl = _breaker_ttl_s()
    if ttl <= 0:
        return
    with _breaker_lock:
        _broken_until[url] = (now if now is not None else time.time()) + ttl
        if len(_broken_until) > 1024:
            cutoff = time.time()
            for k in [k for k, v in _broken_until.items() if v <= cutoff]:
                del _broken_until[k]


def note_success(url: str) -> None:
    """A working round-trip clears the penalty immediately."""
    with _breaker_lock:
        _broken_until.pop(url, None)


def penalized(url: str, now: float | None = None) -> bool:
    with _breaker_lock:
        until = _broken_until.get(url)
    if until is None:
        return False
    return (now if now is not None else time.time()) < until


def _partition_healthy(items: list, netloc_of) -> list:
    """Stable-partition recently-failed replicas to the tail; when
    EVERY candidate is penalized the original order stands (a fully
    demoted list must still be tried, not emptied). The ONE home for
    the demotion rule — url-string and Location callers both route
    here so the edge cases can't drift apart."""
    now = time.time()
    good = [it for it in items if not penalized(netloc_of(it), now)]
    if not good or len(good) == len(items):
        return items
    return good + [it for it in items if it not in good]


def order_by_health(urls: list[str]) -> list[str]:
    """Breaker ordering for "host:port/fid" candidate urls."""
    return _partition_healthy(urls, lambda u: u.partition("/")[0])


class VidMap:
    def __init__(self) -> None:
        self._lock = threading.RLock()
        self._vid2locations: dict[int, list[Location]] = {}
        self._counter = itertools.count()

    def lookup(self, vid: int) -> list[Location]:
        with self._lock:
            return list(self._vid2locations.get(vid, ()))

    def lookup_file_id(self, fid: str) -> list[str]:
        """fid "3,0144b2c3" → ["host:port/3,0144b2c3", ...] full urls
        (wdclient/vid_map.go LookupFileId)."""
        parts = fid.split(",")
        if len(parts) != 2 or not parts[0].isdigit():
            raise ValueError(f"invalid file id {fid!r}")
        locations = self.lookup(int(parts[0]))
        if not locations:
            raise KeyError(f"volume {parts[0]} not found")
        # rotate so repeated reads spread over replicas, then demote
        # replicas with a recent connection error (circuit breaker):
        # fixed round-robin was health-blind, so a dead node ate one
        # timeout on every other lookup
        start = next(self._counter) % len(locations)
        ordered = _partition_healthy(
            locations[start:] + locations[:start], lambda loc: loc.url
        )
        return [f"http://{loc.url}/{fid}" for loc in ordered]

    def note_failure(self, url: str) -> None:
        """Callers report a connection error against a replica url so
        subsequent lookups demote it for the breaker TTL."""
        note_failure(url)

    def note_success(self, url: str) -> None:
        note_success(url)

    def add_location(self, vid: int, loc: Location) -> None:
        with self._lock:
            locs = self._vid2locations.setdefault(vid, [])
            if loc not in locs:
                locs.append(loc)

    def delete_location(self, vid: int, url: str) -> None:
        with self._lock:
            locs = self._vid2locations.get(vid)
            if not locs:
                return
            locs[:] = [l for l in locs if l.url != url]
            if not locs:
                del self._vid2locations[vid]

    def delete_server(self, url: str) -> None:
        """Drop every vid entry pointing at a dead server."""
        with self._lock:
            for vid in list(self._vid2locations):
                self.delete_location(vid, url)

    def __len__(self) -> int:
        with self._lock:
            return len(self._vid2locations)
