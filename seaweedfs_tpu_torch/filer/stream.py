"""Read-side streaming: chunk views → bytes from volume servers
(weed/filer2/stream.go StreamContent).

Each view's fid is resolved through the master (operation.lookup cache)
and fetched from a volume server; sub-chunk views slice the fetched
needle. Reference parity: a sparse hole ends the stream — views stop at
the first gap and nothing is zero-filled (filechunks.go semantics,
pinned by the ported view tests).

QoS plane (docs/QOS.md): when the volume has more than one replica,
chunk fetches ride the hedged-read driver — a read that outlives the
volume's adaptive latency quantile fires a second attempt at the next
replica and cancels the loser. This is the path the filer's own GET
handler reads through, and the S3 and WebDAV gateways read through that
handler, so one seam hedges every reader at once. Replica order passes through
the client circuit breaker (vid_map), so a recently-dead replica is
tried last. `WEED_QOS=0`/`WEED_QOS_HEDGE=0` restores the plain
single-attempt read wholesale.

The port of seaweedfs_tpu/filer/stream.py.
"""

from __future__ import annotations

from seaweedfs_tpu_torch.client import operation as op
from seaweedfs_tpu_torch.client import vid_map as _vm
from seaweedfs_tpu_torch.filer import filechunks


def _replica_urls(master: str, fid: str) -> tuple[list[str], set[str]]:
    """("host:port/fid" candidates healthiest-first, suspect netlocs).

    The master orders suspects last and flags them (health plane,
    docs/HEALTH.md); the client breaker re-partitions on top for
    failures only THIS process has seen. Single-replica volumes return
    one url."""
    vid = fid.split(",")[0]
    result = op.lookup(master, vid)
    if result.error:
        raise RuntimeError(result.error)
    if not result.locations:
        raise RuntimeError(f"volume {vid} has no locations")
    suspects = {
        loc["url"] for loc in result.locations if loc.get("suspect")
    }
    return (
        _vm.order_by_health(
            [f"{loc['url']}/{fid}" for loc in result.locations]
        ),
        suspects,
    )


def _fetch_once(master: str, fid: str) -> bytes:
    urls, suspects = _replica_urls(master, fid)
    if len(urls) < 2:
        data, _ = op.download(urls[0])
        return data
    from seaweedfs_tpu_torch.qos import hedge

    data, _ = hedge.download(
        urls,
        key=fid.split(",")[0],
        eager=urls[0].partition("/")[0] in suspects,
    )
    return data


def fetch_chunk(master: str, fid: str) -> bytes:
    """One chunk fid → bytes, hedged across replicas when possible.

    When the best remaining candidate is a master-flagged SUSPECT (a
    gray node: reachable, probably slow-or-dead), the hedge fires
    EAGERLY — both replicas race from the start instead of waiting out
    the adaptive delay against a node the cluster already distrusts.

    A cached lookup can outlive its locations: `ec.encode` moves a
    volume's bytes onto its shard holders, and a holder can die while
    the cache still names it alone. When every cached location fails,
    the volume is looked up afresh once and the fetch tried again (a
    port departure: the reference keeps the stale entry for the cache's
    10 minutes)."""
    try:
        return _fetch_once(master, fid)
    except OSError:
        if not op.forget_lookup(master, fid.split(",")[0]):
            raise
        return _fetch_once(master, fid)


def stream_content(master: str, chunks, offset: int = 0, size: int | None = None):
    """Yield the file's bytes for [offset, offset+size)."""
    if size is None:
        size = filechunks.total_size(chunks) - offset
    for view in filechunks.view_from_chunks(chunks, offset, size):
        data = fetch_chunk(master, view.fid)
        yield data[view.offset : view.offset + view.size]


def read_all(master: str, chunks) -> bytes:
    return b"".join(stream_content(master, chunks))
