"""Read-availability harness: hammer a keyset through an HTTP endpoint
while a cluster transition (EC migration, rebalance, vacuum) runs
underneath, recording every latency and every failure.

The port of seaweedfs_tpu/util/availability.py: the harness BASELINE
config 5 uses (the ec.encode pipeline's ordering, shards mounted before
the volume is deleted, volume_grpc_erasure_coding.go:25-36, keeps reads
green throughout), the port's cluster tests and chip_smoke.py's cluster
phase. Its free_port walks the reference allocator's range from another
starting point, so servers of both packages in one process do not get
the same port.
"""

from __future__ import annotations

import threading
import time
import urllib.error
import urllib.request


class HammerReader(threading.Thread):
    """Reads every key in a loop through `base_url` until stopped,
    verifying full body equality (covers cookie + CRC: any torn or
    stale byte fails the comparison). Records per-request latency and
    every failure."""

    def __init__(self, base_url: str, keys: dict[str, bytes], label: str):
        super().__init__(daemon=True)
        self.base_url = base_url
        self.keys = keys
        self.label = label
        self.stop_event = threading.Event()
        self.latencies: list[float] = []
        self.failures: list[str] = []
        self.reads = 0

    def run(self):
        items = list(self.keys.items())
        while not self.stop_event.is_set():
            for fid, want in items:
                t0 = time.perf_counter()
                try:
                    with urllib.request.urlopen(
                        f"{self.base_url}/{fid}", timeout=10
                    ) as r:
                        body = r.read()
                        status = r.status
                except urllib.error.HTTPError as e:
                    body, status = b"", e.code
                except Exception as e:  # noqa: BLE001 - count as failure
                    self.failures.append(f"{self.label} {fid}: {e!r}")
                    continue
                finally:
                    self.latencies.append(time.perf_counter() - t0)
                    self.reads += 1
                if status != 200:
                    self.failures.append(f"{self.label} {fid}: HTTP {status}")
                elif body != want:
                    self.failures.append(
                        f"{self.label} {fid}: body mismatch "
                        f"({len(body)} vs {len(want)} bytes)"
                    )


def run_with_readers(readers, transition, settle: float = 0.5) -> None:
    """Start readers, run transition(), let readers keep hammering for
    `settle` seconds of post-transition reads, then stop and join."""
    for r in readers:
        r.start()
    try:
        transition()
        time.sleep(settle)
    finally:
        for r in readers:
            r.stop_event.set()
        for r in readers:
            r.join(timeout=30)


_port_state = {"next": None}
_port_lock = threading.Lock()


def free_port() -> int:
    """A listen port for a test/bench server.

    NOT a bare port-0 probe: that hands back a port inside the
    kernel's ephemeral range (`ip_local_port_range`, 32768+ here), and
    any outbound connection the process — or a sibling daemon — makes
    before the server binds can be assigned that exact port as its
    LOCAL port, turning the later bind into EADDRINUSE. Under a full
    tier-1 run (hundreds of servers, thousands of client dials) that
    race killed whole module fixtures ~1 run in 3.

    Instead: walk a range strictly BELOW the ephemeral floor
    (20000–22699 — chosen so the +10000 gRPC sibling convention stays
    below it too), per-process offset against concurrent suites, and
    verify BOTH the port and its +10000 sibling are bindable before
    handing it out (servers bind both; the old probe never checked
    the sibling). Both packages derive a server's gRPC port as its
    HTTP port + 10000, so a test holding servers of both in one process
    needs both allocators apart: this one starts half the range away
    from the reference's."""
    import os
    import socket

    with _port_lock:
        if _port_state["next"] is None:
            _port_state["next"] = 20000 + ((os.getpid() % 27) * 100 + 1350) % 2700
        for _ in range(2700):
            p = _port_state["next"]
            _port_state["next"] = p + 1 if p + 1 < 22700 else 20000
            try:
                s1 = socket.socket()
                s1.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
                s1.bind(("127.0.0.1", p))
                try:
                    s2 = socket.socket()
                    s2.setsockopt(
                        socket.SOL_SOCKET, socket.SO_REUSEADDR, 1
                    )
                    try:
                        s2.bind(("127.0.0.1", p + 10000))
                    finally:
                        s2.close()
                finally:
                    s1.close()
                return p
            except OSError:
                continue
    # range exhausted (never expected): the old ephemeral probe is
    # still better than failing outright
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def write_keyset(master_port: int, collection: str, n: int = 40, payload_fn=None):
    """Write n blobs with replication=001; return (vid, {fid: payload},
    source_url) for the volume that received the most keys.
    payload_fn(i) -> bytes sizes each blob (default ~1 KB)."""
    import json as _json

    if payload_fn is None:
        def payload_fn(i):
            return (f"key {i} of {collection} ".encode() * 97)[: 997 + 13 * i]

    by_vid: dict[int, dict[str, bytes]] = {}
    url_by_vid: dict[int, str] = {}
    for i in range(n):
        with urllib.request.urlopen(
            f"http://127.0.0.1:{master_port}/dir/assign"
            f"?collection={collection}&replication=001",
            timeout=10,
        ) as r:
            assign = _json.loads(r.read())
        payload = payload_fn(i)
        urllib.request.urlopen(
            urllib.request.Request(
                f"http://{assign['url']}/{assign['fid']}",
                data=payload,
                method="POST",
            ),
            timeout=10,
        ).close()
        vid = int(assign["fid"].split(",")[0])
        by_vid.setdefault(vid, {})[assign["fid"]] = payload
        url_by_vid[vid] = assign["url"]
    vid = max(by_vid, key=lambda v: len(by_vid[v]))
    return vid, by_vid[vid], url_by_vid[vid]


def start_cluster(
    dirs: list[str],
    volume_size_limit_mb: int = 64,
    heartbeat_interval: float = 0.2,
    ready_timeout: float = 45.0,
    master_kwargs: dict | None = None,
    **vs_kwargs,
):
    """Boot 1 master + one VolumeServer per dir (rack{i%2} layout) and
    wait until every node has registered. Returns (master, servers);
    caller stops them. chip_smoke.py's cluster phase and the port's
    cluster tests boot through it. `master_kwargs` feeds MasterServer;
    `vs_kwargs` feed every VolumeServer (ec_codec, device,
    scrub_interval)."""
    from seaweedfs_tpu_torch.server.master_server import MasterServer
    from seaweedfs_tpu_torch.server.volume_server import VolumeServer

    master = MasterServer(
        port=free_port(),
        volume_size_limit_mb=volume_size_limit_mb,
        **(master_kwargs or {}),
    )
    master.start()
    servers = []
    try:
        for i, d in enumerate(dirs):
            vs = VolumeServer(
                [d],
                port=free_port(),
                master=f"127.0.0.1:{master.port}",
                rack=f"rack{i % 2}",
                heartbeat_interval=heartbeat_interval,
                max_volume_counts=[100],
                **vs_kwargs,
            )
            vs.start()
            servers.append(vs)
        deadline = time.time() + ready_timeout
        while (
            time.time() < deadline
            and len(master.topology.data_nodes()) < len(dirs)
        ):
            time.sleep(0.05)
        if len(master.topology.data_nodes()) < len(dirs):
            raise RuntimeError("cluster not ready: not all nodes registered")
    except BaseException:
        for vs in servers:
            vs.stop()
        master.stop()
        raise
    return master, servers
