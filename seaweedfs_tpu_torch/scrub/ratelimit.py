"""Token bucket: the scrub plane's foreground-p99 guardrail.

Every byte the scrubber reads (local pread or remote shard fetch) is
charged here BEFORE the read happens, so a sweep can never burst past
its configured bandwidth and starve foreground reads of the same
spindle/NIC. rate <= 0 disables limiting (bench mode).
"""

from __future__ import annotations

import threading
import time


class TokenBucket:
    def __init__(self, rate_bytes_s: float, burst_bytes: int | None = None):
        self.rate = float(rate_bytes_s)
        # default burst: one second of rate — big enough for a 4 MiB
        # verify tile at any sane rate, small enough that a wake-up
        # after idle can't dump minutes of backlog at once
        self.burst = float(
            burst_bytes if burst_bytes is not None else max(self.rate, 1.0)
        )
        self._tokens = self.burst
        self._last = time.monotonic()
        self._lock = threading.Lock()

    def _refill_locked(self) -> None:
        now = time.monotonic()
        self._tokens = min(
            self.burst, self._tokens + (now - self._last) * self.rate
        )
        self._last = now

    def take(self, n: int, stop: threading.Event | None = None) -> bool:
        """Block until the bucket can admit the request, then charge
        the FULL `n` — the balance may go negative (debt), and later
        takes wait the debt out. This keeps the long-run rate exact
        for requests larger than the burst (clamping the charge would
        silently run a 4 MiB-tile scrub at 4x a 1 MB/s cap); a single
        oversized read still can't deadlock, because the admission
        threshold is min(n, burst). Returns False (without consuming)
        when `stop` fires first."""
        if self.rate <= 0:
            return True
        need = min(float(n), self.burst)
        while True:
            with self._lock:
                self._refill_locked()
                if self._tokens >= need:
                    self._tokens -= float(n)
                    return True
                wait = (need - self._tokens) / self.rate
            # sleep outside the lock; cap so stop stays responsive
            wait = min(wait, 0.5)
            if stop is not None:
                if stop.wait(wait):
                    return False
            else:
                time.sleep(wait)
