"""Singleflight leases: N concurrent requests for one cold key, ONE
worker doing the expensive fill (the port of
seaweedfs_tpu/qos/singleflight.py; EcVolume's degraded-read tile decode
is its user). The protocol:

  * lead(key) registers this thread as the key's leader and returns a
    lease, or returns None when another leader is already in flight;
  * followers wait(key) on the leader's lease, then re-probe whatever
    cache the leader was filling — a miss after the wakeup means the
    leader FAILED (or its result was already evicted), and the
    follower self-serves rather than waiting forever;
  * release(key, lease) unregisters the lease and wakes every waiter.
    Release is owner-checked: a lease can only remove itself, so a
    stale release (leader that already timed out a follower's patience
    and was replaced) cannot evict a successor's registration.

The contract: at most one live lease per
key, every follower wakes, and no lease outlives its run (a leaked
lease would wedge every later request for the key into the wait
path's timeout).
"""

from __future__ import annotations

import threading


class SingleFlight:
    """dict-of-Events registrant handoff; all methods thread-safe."""

    def __init__(self) -> None:
        self._lock = threading.Lock()
        self._leases: dict = {}

    def lead(self, key) -> threading.Event | None:
        """Try to become `key`'s leader: the returned lease (an Event)
        must later be passed to release(). None = someone else leads;
        wait() on them and re-probe."""
        with self._lock:
            if key in self._leases:
                return None
            ev = threading.Event()
            self._leases[key] = ev
            return ev

    def wait(self, key, timeout: float | None = None) -> bool:
        """Block until `key`'s current leader releases (True), the
        timeout lapses (False), or there is no leader at all (True —
        the fill already finished or never started; probe and
        self-serve)."""
        with self._lock:
            ev = self._leases.get(key)
        if ev is None:
            return True
        return ev.wait(timeout)

    def release(self, key, lease: threading.Event) -> None:
        """Unregister `lease` and wake its waiters. Owner-checked: only
        the exact registered lease unregisters, so a late release never
        evicts a successor leader's registration (its waiters still get
        woken — they re-probe, the universal recovery move)."""
        with self._lock:
            if self._leases.get(key) is lease:
                del self._leases[key]
        lease.set()

    def inflight(self) -> int:
        """Outstanding lease count (test/status surface)."""
        with self._lock:
            return len(self._leases)
