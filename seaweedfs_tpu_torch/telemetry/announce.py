"""Gateway → master registration heartbeats.

Volume servers are discovered from their gRPC heartbeats, but the
filer/S3/WebDAV gateways have no channel to the master the collector
could observe — so they announce themselves over plain HTTP:
`GET /cluster/register?kind=<k>&addr=<host:port>` on an interval. The
master records (kind, addr, last_seen); the collector turns entries
into scrape targets. Registration is best-effort and rotates through
the master list on failure (any master accepts; followers proxy the
GET to the leader the same way /vol/vacuum does) — a dead master must
never take a gateway down with it.

The port of seaweedfs_tpu/telemetry/announce.py. The thread ends once
`stop_event` (its `.stop_event`) is set.
"""

from __future__ import annotations

import threading
import urllib.parse
import urllib.request

from seaweedfs_tpu_torch.util import wlog


def start_announce_loop(
    kind: str,
    addr: str,
    masters: list[str],
    interval: float = 10.0,
    stop_event: threading.Event | None = None,
) -> threading.Thread | None:
    """Announce `addr` as a `kind` gateway to the first reachable
    master every `interval` seconds until `stop_event` is set. Returns
    the loop thread (None when there are no masters to announce to)."""
    masters = [m for m in masters if m]
    if not masters:
        return None
    stop = stop_event or threading.Event()
    q = urllib.parse.urlencode({"kind": kind, "addr": addr})
    state = {"idx": 0, "warned": False}

    def announce_once() -> bool:
        for _ in range(len(masters)):
            m = masters[state["idx"] % len(masters)]
            try:
                with urllib.request.urlopen(
                    f"http://{m}/cluster/register?{q}", timeout=5
                ) as r:
                    r.read()
                state["warned"] = False
                return True
            except OSError as e:
                state["idx"] += 1
                last_err = e
        if not state["warned"]:  # log once per outage, not per tick
            state["warned"] = True
            wlog.warning(
                "telemetry: %s %s cannot register with any master "
                "(last: %s); will keep retrying",
                kind, addr, last_err,
            )
        return False

    def loop():
        announce_once()
        while not stop.wait(interval):
            announce_once()

    t = threading.Thread(
        target=loop, daemon=True, name=f"announce-{kind}"
    )
    t.stop_event = stop
    t.start()
    return t
