"""QoS / tail-latency plane (docs/QOS.md).

The port carries the singleflight leases and the first-k-wins gather
the EC degraded read uses (singleflight.py, hedge.py), the hedged
replica reads weedload's GET workers drive (hedge.py), the admission
controller and group committer of the volume server (admission.py,
group_commit.py), and the feature switches and load tracker below.

Four defenses for p99.9 under heavy multi-tenant contention, each
individually switchable and all killable at once:

  * hedged replica reads with an adaptive per-volume delay (hedge.py)
  * per-client admission control at the serving edge (admission.py)
  * group commit on the volume write path (group_commit.py)
  * queue-depth-aware write assignment in the master (the volume
    servers report in-flight/queue depth on heartbeats; the master's
    pick-for-write runs power-of-two-choices over them)

`WEED_QOS=0` restores pre-QoS behavior wholesale; the per-feature
switches (`WEED_QOS_HEDGE`, `WEED_QOS_ADMISSION`, `WEED_QOS_COMMIT`,
`WEED_QOS_ASSIGN`) flip one defense at a time for A/B runs. Env vars
are read per call so a test (or an operator restarting one daemon) can
flip a feature without touching module import order.
"""

from __future__ import annotations

import os
import threading

# the hedge hop header: the client stamps it on the SECOND (hedged)
# attempt so servers can tell tied reads apart from first attempts —
# they count them (weed_hedge_served_total) and annotate the span, and
# the loser's teardown (client closes the socket) is how "drop the
# loser" reaches the server
HEDGE_HEADER = "x-weed-hedge"


def _feature_reads() -> dict[str, str]:
    """Literal per-feature env reads (one os.environ.get per name, so
    the weedlint contract tier can cross-check each knob against the
    OPERATIONS.md table — an f-string composed name would be invisible
    to it)."""
    return {
        "hedge": os.environ.get("WEED_QOS_HEDGE", "1"),
        "admission": os.environ.get("WEED_QOS_ADMISSION", "1"),
        "commit": os.environ.get("WEED_QOS_COMMIT", "1"),
        "assign": os.environ.get("WEED_QOS_ASSIGN", "1"),
    }


def enabled(feature: str = "") -> bool:
    """True when the QoS plane (and, if given, `feature`) is on.
    feature ∈ {"hedge", "admission", "commit", "assign"}."""
    if os.environ.get("WEED_QOS", "1") == "0":
        return False
    if feature:
        return _feature_reads()[feature] != "0"
    return True


class LoadTracker:
    """In-flight request counter for one serving process.

    The mini request loop (util/httpd.serve_connection) enters/exits
    around each dispatch when the server installs one of these; the
    volume server ships the current value to the master on every
    heartbeat (in_flight_requests) so pick-for-write can weigh nodes by
    live load, not just volume counts.

    Also counts 5xx responses served (the funnel calls note_error);
    the cumulative total rides heartbeats as `request_errors`, feeding
    the master health plane's per-node error EWMA (docs/HEALTH.md)."""

    __slots__ = ("_n", "_errors", "_lock")

    def __init__(self) -> None:
        self._n = 0
        self._errors = 0
        self._lock = threading.Lock()

    def enter(self) -> None:
        with self._lock:
            self._n += 1

    def exit(self) -> None:
        with self._lock:
            self._n -= 1

    def note_error(self) -> None:
        with self._lock:
            self._errors += 1

    def errors(self) -> int:
        with self._lock:
            return self._errors

    def inflight(self) -> int:
        with self._lock:
            return self._n


__all__ = ["HEDGE_HEADER", "LoadTracker", "enabled"]
