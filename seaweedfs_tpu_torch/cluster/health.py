"""weedguard: the volume server's side of the node-health plane
(docs/HEALTH.md, the port of seaweedfs_tpu/cluster/health.py).

The disk watchdog flips a node into read-only lame-duck mode on
repeated EIO/ENOSPC. The master-side scoring (phi-accrual suspicion,
error EWMAs, the healthy/suspect/dead state machine) comes with the
master (ROADMAP item 7); the hinted-handoff spool and its `WEED_HEALTH`
kill switch come with the replica fan-out (item 10).
"""

from __future__ import annotations

import os
import threading
import time


class DiskWatchdog:
    """Volume-server-local graceful degradation: repeated EIO/ENOSPC on
    the serving path flip the node into read-only lame-duck mode —
    announced on the next heartbeat (lame_duck field) so the master
    stops assigning writes here, and enforced locally (POST/DELETE
    shed with 503) so in-flight clients fail over instead of grinding
    against a dying disk.

    Strikes decay: `strikes` IO errors within `window_s` trip it
    (WEED_LAMEDUCK_ERRS / WEED_LAMEDUCK_WINDOW_S). Tripping is sticky
    until an operator restarts the process — a disk that threw EIO
    three times is not healed by the passage of time."""

    def __init__(self, strikes: int | None = None, window_s: float | None = None):
        if strikes is None:
            try:
                strikes = int(os.environ.get("WEED_LAMEDUCK_ERRS", "3"))
            except ValueError:
                strikes = 3
        if window_s is None:
            try:
                window_s = float(os.environ.get("WEED_LAMEDUCK_WINDOW_S", "60"))
            except ValueError:
                window_s = 60.0
        self.strikes = max(1, strikes)
        self.window_s = window_s
        self.io_errors = 0  # cumulative, rides the heartbeat
        self.lame_duck = False
        self._recent: list[float] = []
        self._lock = threading.Lock()
        self.on_trip = None  # callback (e.g. force a heartbeat NOW)

    def note_io_error(self, exc: BaseException | None = None) -> bool:
        """Record one failure if it is disk-class (EIO/ENOSPC/EDQUOT);
        returns True when it was counted — False means "not a disk
        fault, handle it your usual way" (a DeadlineExceeded or a
        connection error must never strike the disk)."""
        import errno as _errno

        if exc is not None:
            eno = getattr(exc, "errno", None)
            if eno not in (_errno.EIO, _errno.ENOSPC, _errno.EDQUOT):
                return False
        now = time.monotonic()
        tripped = False
        with self._lock:
            self.io_errors += 1
            self._recent = [
                t for t in self._recent if now - t <= self.window_s
            ]
            self._recent.append(now)
            if not self.lame_duck and len(self._recent) >= self.strikes:
                self.lame_duck = True
                tripped = True
        if tripped:
            from seaweedfs_tpu_torch.util import wlog

            wlog.error(
                "health: %d IO errors within %.0fs — entering read-only "
                "lame-duck mode (writes shed with 503; restart to clear)",
                len(self._recent), self.window_s,
            )
            cb = self.on_trip
            if cb is not None:
                cb()
        return True
