"""Volume server: the data plane, on the port's store and EC codec.

The port of seaweedfs_tpu/server/volume_server.py: the HTTP blob path
(POST with replica fan-out, GET/HEAD with Range, ETag and 304, redirects
to a holder, DELETE), the status and metrics routes, the volume admin
verbs and the EC verb set over gRPC, with EC encode, rebuild and
degraded-read decodes on the card (`ec_codec="cuda"`, the default, on
`device`; "cpu" or "native" name a host codec). With `master` it
heartbeats its inventory (volume_grpc_client_to_master.go), follows the
leader hint, learns peers from the master for redirects, replica
fan-out and chunk fetches, gathers EC survivors from the servers that
hold them (degraded GETs through EcVolume's `fetch` seam, rebuilds
through `remote_readers`) and copies EC shards from a peer
(VolumeEcShardsCopy over CopyFile). With `scrub_interval > 0` its scrub
engine sweeps every local volume in the background: the EC parity
re-verify and culprit localization run through each EC volume's codec
(K1 on the card), remote shards come through the same fetcher degraded
reads use, and a localized corrupt shard is quarantined. The tier verbs
move a volume's .dat, and /tier/move an EC volume's shards, to a
storage backend and back.

What needs a part of the reference that the port does not have yet
raises NotImplementedError naming its ROADMAP item, at construction for
a parameter and at the call for a verb; it never silently does less:
the -workers internal listener and write sharding (item 8) and Query
(item 11). The
batch EC verbs run the batch arm (K2, with K4 fused into the encode) on
a one-device mesh of `device`; VolumeCopy and the tail verbs pull from
a peer over gRPC. The hinted-handoff spool waits for item 10: until
then a replica's failure fails the write (the reference's
WEED_HANDOFF=0 contract), so no write is acknowledged with fewer
copies than its placement asks for. The
reference's C serving core and C POST path wait for items 5 and 8:
requests run on the threaded mini loop and the Python write path, the
reference's own byte-identical arms.
"""

from __future__ import annotations

import functools
import json
import os
import threading
import time
from concurrent import futures

import grpc

from seaweedfs_tpu_torch import qos, trace
from seaweedfs_tpu_torch.scrub.arbiter import get_arbiter
from seaweedfs_tpu_torch.stats.metrics import VOLUME_READS
from seaweedfs_tpu_torch.util import deadline as _op_deadline
from seaweedfs_tpu_torch.util import wlog
from seaweedfs_tpu_torch.ec import ec_files
from seaweedfs_tpu_torch.ec.ec_volume import NotEnoughShards
from seaweedfs_tpu_torch.pb import master_pb2, rpc, volume_pb2 as pb
from seaweedfs_tpu_torch.util.httpd import (
    JSON_HDR as _JSON_HDR,
    FastHandler,
    WeedHTTPServer,
    etag_matches,
    fast_query,
)

from seaweedfs_tpu_torch.server import write_path
from seaweedfs_tpu_torch.storage.file_id import FileId, parse_path_fid, parse_url_path
from seaweedfs_tpu_torch.storage.needle import Needle
from seaweedfs_tpu_torch.storage.store import Store
from seaweedfs_tpu_torch.storage.volume import (
    CookieMismatch,
    NeedleNotFound,
    Volume,
    VolumeReadOnly,
    volume_base_name,
)

_esc_json = functools.lru_cache(maxsize=2048)(json.dumps)


@functools.lru_cache(maxsize=4096)
def _http_date(ts: int) -> str:
    return time.strftime("%a, %d %b %Y %H:%M:%S GMT", time.gmtime(ts))


COPY_CHUNK = 1024 * 1024


def _needle_manifest_bytes(n: Needle) -> bytes:
    """A chunk manifest's JSON, decompressed per the needle's gzip flag
    (operation.LoadChunkManifest(n.Data, n.IsGzipped()) role): manifests
    are text, so the write path's transparent compression applies."""
    data = bytes(n.data)
    if n.is_gzipped():
        from seaweedfs_tpu_torch.util.compression import try_gunzip

        return try_gunzip(data)
    return data


def _parse_manifest_chunks(data: bytes) -> list[dict] | None:
    """Validate + sort a chunk manifest's chunk list; None if malformed.
    Manifests are client-supplied JSON, so every field is checked."""
    try:
        manifest = json.loads(data)
        chunks = manifest["chunks"]
        for c in chunks:
            if not isinstance(c["fid"], str):
                return None
            c["offset"] = int(c["offset"])
            c["size"] = int(c["size"])
        return sorted(chunks, key=lambda c: c["offset"])
    except (ValueError, KeyError, TypeError):
        return None


class VolumeServer:
    def __init__(
        self,
        directories: list[str],
        host: str = "127.0.0.1",
        port: int = 8080,
        master: str = "",
        public_url: str = "",
        data_center: str = "",
        rack: str = "",
        max_volume_counts: list[int] | None = None,
        heartbeat_interval: float = 2.0,
        read_redirect: bool = False,
        guard=None,
        ec_codec: str = "",
        storage_backends: dict | None = None,
        fix_jpg_orientation: bool = True,
        needle_map_kind: str = "memory",
        reuse_port: bool = False,
        internal_port: int = 0,
        shard_writes: bool = False,
        n_writers: int = 1,
        scrub_interval: float = 600.0,
        scrub_rate_mb_s: float = 64.0,
        serve_idle_ms: int = 0,
        serve_max_reqs: int = 0,
        commit_window_us: int = 0,
        commit_bytes: int = 4 << 20,
        commit_batch: int = 64,
        commit_fsync: bool = False,
        admission_rate: float = 0.0,
        admission_burst: float = 0.0,
        admission_inflight: int = 0,
        admission_procs: int = 1,
        admission_shm_path: str = "",
        announce: str = "",
        device=None,
    ):
        # the planes the port does not have yet refuse up front
        if internal_port or shard_writes:
            raise NotImplementedError(
                "internal_port / shard_writes: the -workers processes are "
                "not ported yet (ROADMAP item 8)"
            )
        # more writer processes: a value other than the reference's
        # default is refused, not ignored
        if n_writers != 1:
            raise NotImplementedError(
                f"n_writers={n_writers!r} needs the -workers processes, "
                "not ported yet (ROADMAP item 8)"
            )
        if storage_backends and "s3" in storage_backends:
            raise NotImplementedError(
                "storage backend s3: the s3api client is not ported yet "
                "(ROADMAP item 11)"
            )
        # `ec.codec` config: "cpu" | "native" | "cuda" | "" (the default
        # backend: cuda unless WEED_EC_CODEC names a host codec), with
        # `device` for cuda (None = the card, "cpu" = the kernels' plain
        # versions). Threaded into every server-side EC code path —
        # generate (ec_encoder.go:173 enc.Encode), rebuild, decode back
        # to a volume, and degraded-read reconstruction (store_ec.go:364
        # enc.ReconstructData).
        self.ec_codec = ec_codec or None
        self.device = device
        if storage_backends:
            # remote-tier backends (storage.backend config tree; the
            # reference ships this from master config in heartbeats,
            # backend.go:78-97)
            from seaweedfs_tpu_torch.storage import backend as _bk

            _bk.ensure_builtin_factories()
            _bk.load_backend_config(storage_backends)
        self.store = Store(
            directories,
            max_volume_counts,
            ec_backend=self.ec_codec,
            needle_map_kind=needle_map_kind,
            device=device,
        )
        self.host = host
        self.port = port
        self.grpc_port = port + 10000
        # seed masters (comma-separated); self.master tracks the one we
        # currently talk to and follows leader hints from heartbeats
        # (volume_grpc_client_to_master.go:34-53)
        self.seed_masters = [m.strip() for m in master.split(",") if m.strip()] if master else []
        self.master = self.seed_masters[0] if self.seed_masters else master
        self._master_rr = 0
        self.public_url = public_url or f"{host}:{port}"
        # advertised INTERNAL address (heartbeat ip/port → the url every
        # peer, repair verb, and replica fan-out dials): differs from
        # the bind address when the cluster must reach this server
        # through a proxy or NAT hop. Self-identity checks go through
        # _self_urls(), which matches BOTH the bind and the announced
        # address.
        self.announce_host, self.announce_port = host, port
        if announce:
            a_host, _, a_port = announce.partition(":")
            self.announce_host, self.announce_port = a_host, int(a_port)
        self.data_center = data_center
        self.rack = rack
        self.heartbeat_interval = heartbeat_interval
        self.read_redirect = read_redirect
        self.guard = guard  # security.Guard; None = security off
        self.fix_jpg_orientation = fix_jpg_orientation
        self.volume_size_limit = 30 * 1024 * 1024 * 1024
        self._stop = threading.Event()
        self._force_full_heartbeat = threading.Event()
        # set by Store.notify_change on any inventory change: wakes the
        # heartbeat generator so the delta beat goes out NOW instead of
        # on the next tick (mount-before-delete ordering stays visible
        # to the master in order)
        self._hb_wake = threading.Event()
        self.store.notify_change = self._hb_wake.set
        self._hb_thread: threading.Thread | None = None
        self._metrics_push: threading.Thread | None = None
        self._metrics_cfg: tuple | None = None
        # vid -> (expires, [urls]); keeps the master off the per-write
        # hot path (the reference's wdclient vidMap role)
        self._location_cache: dict[int, tuple[float, list[str]]] = {}
        self._location_cache_ttl = 10.0
        self._grpc_server: grpc.Server | None = None
        self._grpc_pool: futures.ThreadPoolExecutor | None = None
        self._profiling = False
        self._http_server: WeedHTTPServer | None = None
        # SO_REUSEPORT on the public listener (the reference's -workers
        # read processes share the port through it)
        self.reuse_port = reuse_port
        # scrub plane (docs/SCRUB.md): background integrity sweeps over
        # every local volume, rate-limited so foreground p99 survives.
        # scrub_interval <= 0 disables the engine; quarantine reporting
        # (heartbeats, /status) still works — foreground reads keep
        # quarantining truncated shards either way. The engine's EC
        # sweeps decode through each EC volume's codec, on `device`.
        self.store.node_label = f"{host}:{port}"
        self.scrub = None
        if scrub_interval > 0:
            from seaweedfs_tpu_torch.scrub import ScrubEngine

            self.scrub = ScrubEngine(
                self.store,
                interval=scrub_interval,
                rate_mb_s=scrub_rate_mb_s,
                fetcher_factory=self._scrub_shard_fetcher,
                on_event=self._hb_wake.set,
                node_label=self.store.node_label,
            )
        # keep-alive housekeeping knobs for both serving loops
        # (`-serveIdleMs`/`-serveMaxReqs`, docs/SERVING.md); 0 = off
        self.serve_idle_ms = serve_idle_ms
        self.serve_max_reqs = serve_max_reqs
        # QoS plane (docs/QOS.md): group commit on the write path — a
        # configured committer routes POSTs through commit windows (and
        # per-POST fsync when -commitFsync rides alone); the C POST
        # fast path declines to Python while one is installed so every
        # write can join a window / get its durability flush
        self.group_commit = None
        if commit_window_us > 0 or commit_fsync:
            from seaweedfs_tpu_torch.qos.group_commit import GroupCommitter

            self.group_commit = GroupCommitter(
                window_us=commit_window_us,
                max_bytes=commit_bytes,
                max_batch=commit_batch,
                fsync=commit_fsync,
            )
        # in-flight request tracking, shipped on heartbeats so the
        # master's pick-for-write can weigh nodes by live load
        self.load = qos.LoadTracker()
        # weedguard (docs/HEALTH.md): the local disk watchdog flips the
        # node into read-only lame-duck mode on repeated EIO/ENOSPC
        # (announced on the next forced beat; new writes shed with
        # 503), and SIGTERM sets `draining` (graceful drain — see
        # drain()). The hinted-handoff spool waits for ROADMAP item 10.
        from seaweedfs_tpu_torch.cluster.health import DiskWatchdog

        self.watchdog = DiskWatchdog()
        self.watchdog.on_trip = self._hb_wake.set
        self.draining = False
        # per-client admission control (token bucket + in-flight cap);
        # None = accept everything, today's behavior
        self.admission = None
        if admission_rate > 0 or admission_inflight > 0:
            from seaweedfs_tpu_torch.qos.admission import AdmissionController

            self.admission = AdmissionController(
                rate=admission_rate,
                burst=admission_burst,
                max_inflight=admission_inflight,
                procs=admission_procs,
                label="volume",
                shm_path=admission_shm_path,
            )

    # ------------------------------------------------------------------
    # status UI (server/volume_server_ui/templates.go role)
    def _render_ui(self) -> str:
        import html as _html

        rows = []
        for loc in self.store.locations:
            for vid, v in sorted(loc.volumes.items()):
                rows.append(
                    f"<tr><td>{vid}</td><td>{_html.escape(v.collection)}</td>"
                    f"<td>{v.data_file_size()}</td><td>{v.file_count()}</td>"
                    f"<td>{v.deleted_count()}</td>"
                    f"<td>{'ro' if v.read_only else 'rw'}</td></tr>"
                )
            for vid, ev in sorted(loc.ec_volumes.items()):
                shards = ",".join(str(s) for s in ev.shard_ids())
                rows.append(
                    f"<tr><td>{vid}</td><td>{_html.escape(ev.collection)}</td>"
                    f"<td colspan=3>EC shards: {shards}</td><td>ec</td></tr>"
                )
        from seaweedfs_tpu_torch.util.status_ui import status_page

        return status_page(
            "SeaweedFS-TPU Volume",
            f"Volume Server {self.host}:{self.port}",
            f"master: {_html.escape(self.master or '(none)')} &middot; "
            f"ec codec: {self.ec_codec or 'auto'}",
            ["Id", "Collection", "Size", "Files", "Deleted", "Mode"],
            "".join(rows),
            ["/status", "/metrics"],
        )

    # ------------------------------------------------------------------
    # heartbeat client (volume_grpc_client_to_master.go)
    # full beats every Nth cycle keep master state authoritative; the
    # cycles between send only volume-set changes so steady-state
    # chatter is O(changes), not O(volumes) (master.proto:43-44
    # new_volumes/deleted_volumes delta beats)
    _FULL_HEARTBEAT_EVERY = 10

    @staticmethod
    def _add_vol_stats(field, infos) -> None:
        for v in infos:
            field.add(
                id=v.id,
                size=v.size,
                collection=v.collection,
                file_count=v.file_count,
                delete_count=v.delete_count,
                deleted_byte_count=v.deleted_byte_count,
                read_only=v.read_only,
                replica_placement=v.replica_placement,
                version=v.version,
                ttl=v.ttl,
            )

    def _heartbeat_requests(self):
        last_vids: dict[int, object] | None = None  # None => send full
        last_full_infos: dict[int, object] = {}
        beat = 0
        while not self._stop.is_set():
            # clear BEFORE collecting: a change landing mid-collect
            # re-sets the event and triggers another immediate beat
            # rather than being absorbed into this one and lost
            self._hb_wake.clear()
            if self._force_full_heartbeat.is_set():
                # master asked for the full inventory (it lost our
                # state to a liveness sweep or a leader change)
                self._force_full_heartbeat.clear()
                last_vids = None
            hb = self.store.collect_heartbeat()
            req = master_pb2.HeartbeatRequest(
                ip=self.announce_host,
                port=self.announce_port,
                public_url=self.public_url,
                max_volume_count=sum(
                    loc.max_volume_count for loc in self.store.locations
                ),
                max_file_key=hb.max_file_key,
                data_center=self.data_center,
                rack=self.rack,
                has_no_ec_shards=not hb.ec_shards,
                # QoS plane: live load for queue-depth-aware assignment
                # (master pick_for_write power-of-two-choices)
                in_flight_requests=self.load.inflight(),
                write_queue_depth=(
                    self.group_commit.depth()
                    if self.group_commit is not None
                    else 0
                ),
                # health plane (docs/HEALTH.md): graceful-degradation
                # flags + cumulative error counters for the master's
                # per-node EWMAs
                lame_duck=self.watchdog.lame_duck,
                draining=self.draining,
                io_errors=self.watchdog.io_errors,
                request_errors=self.load.errors(),
            )

            # signature catches in-place changes (growth past the size
            # limit, read-only flips, delete counts) so they propagate
            # on the next delta beat, not only on the Nth full beat
            def sig(v):
                return (v.size, v.file_count, v.delete_count, v.read_only)

            current = {v.id: v for v in hb.volumes}
            full = last_vids is None or beat % self._FULL_HEARTBEAT_EVERY == 0
            if full:
                req.has_no_volumes = not hb.volumes
                self._add_vol_stats(req.volumes, hb.volumes)
            else:
                new = [
                    v
                    for vid, v in current.items()
                    if vid not in last_vids or last_vids[vid] != sig(v)
                ]
                gone = [
                    hb_v
                    for vid, hb_v in last_full_infos.items()
                    if vid not in current
                ]
                self._add_vol_stats(req.new_volumes, new)
                self._add_vol_stats(req.deleted_volumes, gone)
            last_vids = {vid: sig(v) for vid, v in current.items()}
            last_full_infos = current
            beat += 1
            for s in hb.ec_shards:
                req.ec_shards.add(
                    id=s.id, collection=s.collection, ec_index_bits=s.ec_index_bits
                )
            for row in self._collect_scrub_stats():
                req.scrub_stats.add(**row)
            yield req
            # next beat on the tick, on an inventory change, or on stop
            # — whichever comes first
            self._hb_wake.wait(self.heartbeat_interval)

    def _collect_scrub_stats(self) -> list[dict]:
        """ScrubStat heartbeat rows: the engine's health records merged
        with the store's quarantine registry (which also fills when the
        engine is off — foreground reads quarantine truncated shards
        too). Complete snapshot every beat; the master overwrites."""
        rows: dict[tuple[int, bool], dict] = {}
        if self.scrub is not None:
            for h in self.scrub.health_rows():
                rows[(h.volume_id, h.is_ec)] = {
                    "volume_id": h.volume_id,
                    "is_ec": h.is_ec,
                    "last_sweep_unix": int(h.last_sweep_unix),
                    "scanned_bytes": h.scanned_bytes,
                    # CURRENT damage, not history: a repaired volume's
                    # next clean sweep zeroes this, so the master's
                    # repair scheduler converges (cumulative totals
                    # stay in metrics and /scrub/status)
                    "corruptions_found": h.sweep_corruptions,
                    "quarantined_shard_bits": 0,
                    "last_error": h.last_error[:300],
                }
        for vid, per_vid in list(self.store.quarantined.items()):
            row = rows.setdefault(
                (vid, True),
                {
                    "volume_id": vid,
                    "is_ec": True,
                    "last_sweep_unix": 0,
                    "scanned_bytes": 0,
                    "corruptions_found": 0,
                    "quarantined_shard_bits": 0,
                    "last_error": "; ".join(
                        f"shard {sid}: {why}"
                        for sid, why in sorted(per_vid.items())
                    )[:300],
                },
            )
            row["quarantined_shard_bits"] = self.store.quarantined_shard_bits(
                vid
            )
        return list(rows.values())

    def _heartbeat_loop(self) -> None:
        while not self._stop.is_set():
            try:
                with rpc.dial(self._master_grpc()) as ch:
                    stub = rpc.master_stub(ch)
                    for resp in stub.Heartbeat(self._heartbeat_requests()):
                        if resp.volume_size_limit:
                            self.volume_size_limit = resp.volume_size_limit
                        if resp.request_full_heartbeat:
                            self._force_full_heartbeat.set()
                        if resp.metrics_address:
                            # master ships the pushgateway config in the
                            # heartbeat response (master_grpc_server.go:80);
                            # a NEW address/interval (e.g. from a new
                            # leader) replaces the running loop
                            cfg = (
                                resp.metrics_address,
                                resp.metrics_interval_seconds or 15,
                            )
                            if cfg != self._metrics_cfg:
                                self._start_metrics_push(cfg)
                        if resp.leader and resp.leader != self.master:
                            # follow the leader hint: reconnect there
                            self.master = resp.leader
                            break
                        if self._stop.is_set():
                            return
                    else:
                        # stream ended cleanly (e.g. a leaderless
                        # follower redirecting to itself): back off so
                        # election windows don't become a reconnect storm
                        self._stop.wait(0.2)
            except grpc.RpcError:
                # rotate through the seed masters until one answers
                if len(self.seed_masters) > 1:
                    self._master_rr = (self._master_rr + 1) % len(self.seed_masters)
                    self.master = self.seed_masters[self._master_rr]
                self._stop.wait(0.2 if len(self.seed_masters) > 1 else 1.0)

    def _start_metrics_push(self, cfg: tuple) -> None:
        """(Re)start the pushgateway loop for (address, interval). Only
        the heartbeat thread calls this, so the swap needs no lock."""
        from seaweedfs_tpu_torch.stats.metrics import start_push_loop

        self._stop_metrics_push()
        self._metrics_cfg = cfg
        self._metrics_push = start_push_loop(
            f"http://{cfg[0]}",
            job=f"volume_{self.host}_{self.port}",
            interval_sec=cfg[1],
            stop_event=threading.Event(),
        )

    def _stop_metrics_push(self) -> None:
        if self._metrics_push is not None:
            self._metrics_push.stop_event.set()
            self._metrics_push.join(timeout=10)
            self._metrics_push = None

    def _master_grpc(self) -> str:
        host, _, port = self.master.partition(":")
        return f"{host}:{int(port) + 10000}"

    def _lookup_locations(self, vid: int) -> list[str] | None:
        """Replica urls for a vid via the master, cached briefly. None
        when the master is unreachable and nothing is cached."""
        cached = self._location_cache.get(vid)
        now = time.time()
        if cached and cached[0] > now:
            return cached[1]
        try:
            with rpc.dial(self._master_grpc()) as ch:
                resp = rpc.master_stub(ch).LookupVolume(
                    master_pb2.LookupVolumeRequest(vids=[str(vid)]), timeout=5
                )
        except grpc.RpcError:
            return cached[1] if cached else None
        urls = [
            l.url for entry in resp.vid_locations for l in entry.locations
        ]
        self._location_cache[vid] = (now + self._location_cache_ttl, urls)
        return urls

    # ------------------------------------------------------------------
    # gRPC admin servicer
    def AllocateVolume(self, req: pb.AllocateVolumeRequest, context):
        self.store.add_volume(
            req.volume_id, req.collection, req.replication or "000", req.ttl
        )
        return pb.AllocateVolumeResponse()

    def VolumeDelete(self, req: pb.VolumeDeleteRequest, context):
        self.store.delete_volume(req.volume_id)
        return pb.VolumeDeleteResponse()

    def VolumeMount(self, req, context):
        if not self.store.mount_volume(req.volume_id):
            context.abort(grpc.StatusCode.NOT_FOUND, f"volume {req.volume_id} not found")
        return pb.VolumeMountResponse()

    def VolumeUnmount(self, req, context):
        if not self.store.unmount_volume(req.volume_id):
            context.abort(grpc.StatusCode.NOT_FOUND, f"volume {req.volume_id} not found")
        return pb.VolumeUnmountResponse()

    def VolumeMarkReadonly(self, req, context):
        self.store.mark_volume_readonly(req.volume_id)
        return pb.VolumeMarkReadonlyResponse()

    def VolumeMarkWritable(self, req, context):
        self.store.mark_volume_writable(req.volume_id)
        return pb.VolumeMarkWritableResponse()

    def DeleteCollection(self, req: pb.DeleteCollectionRequest, context):
        for loc in self.store.locations:
            doomed = [
                vid
                for vid, vol in loc.volumes.items()
                if vol.collection == req.collection
            ]
            for vid in doomed:
                loc.delete_volume(vid)
        return pb.DeleteCollectionResponse()

    def VolumeSyncStatus(self, req, context):
        v = self.store.find_volume(req.volume_id)
        if v is None:
            context.abort(grpc.StatusCode.NOT_FOUND, f"volume {req.volume_id} not found")
        return pb.VolumeSyncStatusResponse(
            volume_id=v.id,
            collection=v.collection,
            replication=str(v.super_block.replica_placement),
            ttl=str(v.ttl),
            tail_offset=v.data_file_size(),
            compact_revision=v.super_block.compaction_revision,
            idx_file_size=v.nm.index_file_size(),
        )

    def BatchDelete(self, req: pb.BatchDeleteRequest, context):
        out = pb.BatchDeleteResponse()
        for fid_str in req.file_ids:
            result = out.results.add(file_id=fid_str)
            try:
                fid = FileId.parse(fid_str)
                n = Needle(cookie=fid.cookie, id=fid.key)
                size = self.store.delete_needle(fid.volume_id, n)
                result.status = 202
                result.size = size
            except Exception as e:  # noqa: BLE001
                result.status = 500
                result.error = str(e)
        return out

    # vacuum 4-phase (volume_grpc_vacuum.go)
    def VacuumVolumeCheck(self, req, context):
        v = self.store.find_volume(req.volume_id)
        if v is None:
            context.abort(grpc.StatusCode.NOT_FOUND, f"volume {req.volume_id} not found")
        return pb.VacuumVolumeCheckResponse(garbage_ratio=v.garbage_level())

    def VacuumVolumeCompact(self, req, context):
        v = self.store.find_volume(req.volume_id)
        if v is None:
            context.abort(grpc.StatusCode.NOT_FOUND, f"volume {req.volume_id} not found")
        v.compact()
        return pb.VacuumVolumeCompactResponse()

    def VacuumVolumeCommit(self, req, context):
        v = self.store.find_volume(req.volume_id)
        if v is None:
            context.abort(grpc.StatusCode.NOT_FOUND, f"volume {req.volume_id} not found")
        v.commit_compact()
        return pb.VacuumVolumeCommitResponse()

    def VacuumVolumeCleanup(self, req, context):
        v = self.store.find_volume(req.volume_id)
        if v is not None:
            v.cleanup_compact()
        return pb.VacuumVolumeCleanupResponse()

    # copy/tail (volume_grpc_copy.go, volume_grpc_tail.go)
    def VolumeCopy(self, req: pb.VolumeCopyRequest, context):
        """Replicate a whole volume from another node by pulling its
        .dat/.idx over the CopyFile stream (volume_grpc_copy.go:25)."""
        if self.store.has_volume(req.volume_id):
            context.abort(
                grpc.StatusCode.ALREADY_EXISTS,
                f"volume {req.volume_id} already exists",
            )
        loc = self.store.locations[0]
        base = volume_base_name(loc.directory, req.collection, req.volume_id)
        host, _, port = req.source_data_node.partition(":")
        with rpc.dial(f"{host}:{int(port) + 10000}") as ch:
            stub = rpc.volume_stub(ch)
            for ext in (".dat", ".idx"):
                with open(base + ext, "wb") as f:
                    for resp in stub.CopyFile(
                        pb.CopyFileRequest(
                            volume_id=req.volume_id,
                            collection=req.collection,
                            ext=ext,
                        )
                    ):
                        f.write(resp.file_content)
        v = Volume(loc.directory, req.volume_id, req.collection, create=False)
        loc.volumes[req.volume_id] = v
        return pb.VolumeCopyResponse(last_append_at_ns=v.last_append_at_ns)

    def CopyFile(self, req: pb.CopyFileRequest, context):
        """Stream one of this volume's files (.dat, .idx, .ecNN, .ecx,
        .ecj) to a peer in COPY_CHUNK pieces (volume_grpc_copy.go)."""
        base = self._base_name(req.collection, req.volume_id)
        path = base + req.ext
        if not os.path.exists(path):
            context.abort(grpc.StatusCode.NOT_FOUND, f"no file {path}")
        stop = req.stop_offset or os.path.getsize(path)
        with open(path, "rb") as f:
            sent = 0
            while sent < stop:
                chunk = f.read(min(COPY_CHUNK, stop - sent))
                if not chunk:
                    break
                sent += len(chunk)
                yield pb.CopyFileResponse(file_content=chunk)

    def VolumeIncrementalCopy(self, req, context):
        v = self.store.find_volume(req.volume_id)
        if v is None:
            context.abort(grpc.StatusCode.NOT_FOUND, f"volume {req.volume_id} not found")
        # stream the .dat tail whose records are newer than since_ns
        # (binary search over AppendAtNs, volume_backup.go:170); linear
        # scan from the superblock is equivalent on the append-only file
        for blob, _n, _end in self._iter_needles_since(v, req.since_ns):
            yield pb.VolumeIncrementalCopyResponse(file_content=blob)

    # tail follow/replicate (volume_grpc_tail.go)
    def _iter_needles_since(self, v, since_ns: int, start_offset: int = 0):
        """(blob, needle) for needles appended after since_ns, in .dat
        order, starting the scan at start_offset (sendNeedlesSince
        role; linear scan is equivalent to the binary search on the
        append-only file). The generator's .end_offset attribute is
        unusable from a generator, so callers that poll should pass the
        last end offset back in — see VolumeTailSender."""
        from seaweedfs_tpu_torch.storage.needle import get_actual_size
        from seaweedfs_tpu_torch.storage.super_block import SUPER_BLOCK_SIZE

        offset = max(start_offset, SUPER_BLOCK_SIZE + len(v.super_block.extra))
        size = v.data_file_size()
        while offset < size:
            header = v._read_at(offset, 16)
            if len(header) < 16:
                return
            _, _, nsize = Needle.parse_header(header + bytes(16))
            record = get_actual_size(
                nsize if nsize != 0xFFFFFFFF else 0, v.version
            )
            blob = v._read_at(offset, record)
            try:
                n = Needle.from_bytes(blob, v.version)
            except ValueError:
                return
            if n.append_at_ns > since_ns:
                yield blob, n, offset + record
            offset += record

    def VolumeTailSender(self, req, context):
        """Stream needles appended since since_ns as (header, body)
        pairs; keep following until idle for idle_timeout_seconds
        (0 = follow forever) (volume_grpc_tail.go:16-54)."""
        v = self.store.find_volume(req.volume_id)
        if v is None:
            context.abort(
                grpc.StatusCode.NOT_FOUND, f"volume {req.volume_id} not found"
            )
        last_ns = req.since_ns
        draining = req.idle_timeout_seconds
        # resume each poll from the previous end-of-file position: the
        # .dat is append-only, so a follow-forever tail must not rescan
        # the whole volume every 2 seconds
        resume_at = 0
        while not self._stop.is_set():
            progressed = False
            for blob, n, end in self._iter_needles_since(v, last_ns, resume_at):
                yield pb.VolumeTailSenderResponse(
                    needle_header=blob[:16],
                    needle_body=blob[16:],
                    is_last_chunk=False,
                )
                last_ns = max(last_ns, n.append_at_ns)
                resume_at = end
                progressed = True
            if req.idle_timeout_seconds == 0:
                self._stop.wait(2.0)
                continue
            if progressed:
                draining = req.idle_timeout_seconds
            else:
                draining -= 1
                if draining <= 0:
                    return
            self._stop.wait(1.0)

    def VolumeTailReceiver(self, req, context):
        """Pull a source server's tail into the local volume
        (volume_grpc_tail.go:79 VolumeTailReceiver)."""
        v = self.store.find_volume(req.volume_id)
        if v is None:
            context.abort(
                grpc.StatusCode.NOT_FOUND, f"volume {req.volume_id} not found"
            )
        host, _, port = req.source_volume_server.partition(":")
        with rpc.dial(f"{host}:{int(port) + 10000}") as ch:
            for resp in rpc.volume_stub(ch).VolumeTailSender(
                pb.VolumeTailSenderRequest(
                    volume_id=req.volume_id,
                    since_ns=req.since_ns,
                    idle_timeout_seconds=req.idle_timeout_seconds or 2,
                )
            ):
                blob = resp.needle_header + resp.needle_body
                try:
                    n = Needle.from_bytes(blob, v.version)
                except ValueError:
                    continue
                if len(n.data) == 0:
                    # zero-size record = tombstone (the reference keys
                    # replicated deletes off n.Size == 0 the same way)
                    v.delete_needle(n)
                else:
                    v.write_needle(n)
        return pb.VolumeTailReceiverResponse()

    # EC verbs (volume_grpc_erasure_coding.go)
    def _base_name(self, collection: str, vid: int) -> str:
        v = self.store.find_volume(vid)
        if v is not None:
            return v.base_name
        for loc in self.store.locations:
            base = volume_base_name(loc.directory, collection, vid)
            if any(
                os.path.exists(base + ext)
                for ext in (".dat", ".ecx", ".ec00", ".idx")
            ):
                return base
        return volume_base_name(self.store.locations[0].directory, collection, vid)

    def _new_rs(self):
        from seaweedfs_tpu_torch.ec.codec import new_encoder

        return new_encoder(backend=self.ec_codec, device=self.device)

    def VolumeEcShardsGenerate(self, req, context):
        v = self.store.find_volume(req.volume_id)
        if v is None:
            context.abort(grpc.StatusCode.NOT_FOUND, f"volume {req.volume_id} not found")
        base = v.base_name
        # durable ordering (weedcrash ec-encode workload): shard bytes
        # fsynced BEFORE the .ecx publish — a crash can then never leave
        # a complete-looking index over page-cache-only shard files.
        # want_crcs: the pipelined drivers fold per-shard CRC-32C out of
        # the codec pass for free — logged so an operator can cross-check
        # a suspect shard file against the encode-time checksum without
        # re-reading the survivors
        st: dict = {}
        ec_files.write_ec_files(
            base, rs=self._new_rs(), durable=True, stats=st, want_crcs=True
        )
        crcs = st.get("shard_crcs")
        if crcs:
            wlog.info(
                "ec.generate vid=%s shard_crc32c=%s",
                req.volume_id,
                ",".join(f"{c:08x}" for c in crcs),
            )
            self._publish_ecc(base, crcs)
        ec_files.write_sorted_file_from_idx(base, durable=True)
        return pb.VolumeEcShardsGenerateResponse()

    def _batch_codec(self):
        """The batch verbs' codec. A host codec named by `ec_codec` (or
        by WEED_EC_CODEC when it is unset) runs the host arm, as the
        single-volume verbs do. Otherwise a one-device MeshCodec on this
        server's `device` ("cpu" runs the kernels' plain versions), or
        None on a card server without one: a mesh over every card, which
        raises where there is none. Never the host codec in its place."""
        from seaweedfs_tpu_torch.ec import ec_stream
        from seaweedfs_tpu_torch.ec.codec import default_backend

        if (self.ec_codec or default_backend()) in ("cpu", "native"):
            return ec_stream._HostBatchCodec(self._new_rs())
        if self.device is None:
            return None
        from seaweedfs_tpu_torch.parallel import MeshCodec, make_mesh

        return MeshCodec(make_mesh([self.device]))

    def VolumeEcShardsBatchGenerate(self, req, context):
        """N local sealed volumes → shard files through one MeshCodec
        round per tile (ec_files.write_ec_files_batch: K2 with K4 fused).
        With durable=True it fsyncs every shard file before
        returning on both arms, so the .ecx publish below can imply
        shard bytes are on disk (the single-volume verb's ordering)."""
        bases = []
        for vid in req.volume_ids:
            v = self.store.find_volume(vid)
            if v is None:
                context.abort(
                    grpc.StatusCode.NOT_FOUND, f"volume {vid} not found"
                )
            bases.append(v.base_name)
        if bases:
            st: dict = {}
            ec_files.write_ec_files_batch(
                bases, codec=self._batch_codec(), durable=True, stats=st,
                want_crcs=True,
            )
            for vid, base, crcs in zip(
                req.volume_ids, bases, st.get("shard_crcs") or []
            ):
                wlog.info(
                    "ec.batch_generate vid=%s shard_crc32c=%s",
                    vid,
                    ",".join(f"{c:08x}" for c in crcs),
                )
                self._publish_ecc(base, crcs)
            for base in bases:
                ec_files.write_sorted_file_from_idx(base, durable=True)
        return pb.VolumeEcShardsBatchGenerateResponse()

    def VolumeEcShardsRebuild(self, req, context):
        """Regenerate missing shard files. With every survivor local
        this is the classic local-file rebuild; when survivors are
        missing locally but mounted elsewhere (the rack-gather case),
        the pipelined ec_stream driver reads those shards straight off
        their holders tile by tile, decoding on the card as they
        arrive."""
        with trace.span(
            "volume.ec_rebuild",
            header=trace.header_from_grpc_context(context),
            node=f"{self.host}:{self.port}",
        ) as sp:
            if sp:
                sp.annotate("vid", req.volume_id)
            return self._ec_shards_rebuild(req, context)

    def _ec_shards_rebuild(self, req, context):
        base = self._base_name(req.collection, req.volume_id)
        present, missing = ec_files.shard_presence(base)
        if not missing or not self.master:
            st: dict = {}
            rebuilt = ec_files.rebuild_ec_files(
                base, rs=self._new_rs(), durable=True, stats=st,
                want_crcs=True,
            )
            self._log_rebuild_crcs(req.volume_id, base, st)
            return pb.VolumeEcShardsRebuildResponse(rebuilt_shard_ids=rebuilt)
        # with a master, always learn which "missing" shards are in
        # fact mounted elsewhere: they serve as remote survivors and
        # are EXCLUDED from the rebuild targets — even a rebuilder
        # holding >= 10 local shards must not regenerate (and later
        # double-mount) shards the cluster still has
        readers, close_readers = self._remote_rebuild_readers(
            req.volume_id, {i for i, p in enumerate(present) if p}
        )
        try:
            if not readers:
                st = {}
                rebuilt = ec_files.rebuild_ec_files(
                    base, rs=self._new_rs(), durable=True, stats=st,
                    want_crcs=True,
                )
                self._log_rebuild_crcs(req.volume_id, base, st)
            else:
                from seaweedfs_tpu_torch.ec import ec_stream, repair_session

                rs = self._new_rs()
                rebuild_fn = fetch_fn = None
                if not ec_files._use_stream_driver(rs):
                    # a host codec: its matrix apply in the writer pool
                    rebuild_fn, fetch_fn = ec_stream.local_rebuild_fns(
                        rs, want_crcs=True
                    )
                # repair piggyback (docs/SCRUB.md): degraded GETs of
                # this volume donate the tiles they decode while the
                # session is open, and tiles already decoded for past
                # degraded reads seed it — the driver then gathers
                # survivors only for the gaps
                targets = [i for i in missing if i not in readers]
                sess = repair_session.open_session(req.volume_id, targets)
                try:
                    # inside the try: a raise here must still unregister
                    # the session, or every later degraded read donates
                    # into a dead one
                    ev = self.store.find_ec_volume(req.volume_id)
                    if ev is not None:
                        ev.donate_cached_tiles(sess)
                    st = {}
                    rebuilt = ec_stream.stream_rebuild_ec_files(
                        base,
                        rebuild_fn=rebuild_fn,
                        fetch_fn=fetch_fn,
                        remote_readers=readers,
                        session=sess,
                        durable=True,
                        stats=st,
                        want_crcs=True,
                        device=rs.device,
                    )
                    self._log_rebuild_crcs(req.volume_id, base, st)
                except ValueError as e:
                    context.abort(grpc.StatusCode.FAILED_PRECONDITION, str(e))
                finally:
                    repair_session.close_session(sess)
        finally:
            close_readers()
        return pb.VolumeEcShardsRebuildResponse(rebuilt_shard_ids=rebuilt)

    def _remote_rebuild_readers(self, vid: int, skip: set[int]):
        """(readers, closer): shard id → fetch(offset, size) callables
        over VolumeEcShardRead against holders learned from the master,
        for survivors not in `skip` (the locally-present set). One
        cached channel per holder — the stream driver's reader pool
        calls these concurrently, and grpc channels are thread-safe."""
        if not self.master:
            return {}, (lambda: None)
        try:
            with rpc.dial(self._master_grpc()) as ch:
                resp = rpc.master_stub(ch).LookupEcVolume(
                    master_pb2.LookupEcVolumeRequest(volume_id=vid),
                    timeout=5,
                )
        except grpc.RpcError:
            return {}, (lambda: None)
        me = self._self_urls()
        locations: dict[int, list[str]] = {}
        for entry in resp.shard_id_locations:
            urls = [l.url for l in entry.locations if l.url not in me]
            if urls and entry.shard_id not in skip:
                locations[entry.shard_id] = urls
        channels: dict[str, grpc.Channel] = {}
        channels_lock = threading.Lock()

        def channel(url: str) -> grpc.Channel:
            with channels_lock:
                ch = channels.get(url)
                if ch is None:
                    host, _, port = url.partition(":")
                    ch = channels[url] = rpc.dial(f"{host}:{int(port) + 10000}")
                return ch

        # capture the trace context and the ambient deadline NOW: the
        # stream driver's reader pool calls these from its own threads,
        # where neither is ambient; each read's timeout shrinks to what
        # remains of the caller's budget
        md = trace.grpc_metadata()
        factory_dl = _op_deadline.current()

        def make_reader(sid: int, urls: list[str]):
            def read(offset: int, size: int) -> bytes:
                # rebuild traffic pays the bandwidth arbiter before
                # pulling remote bytes, yielding to foreground serving
                get_arbiter().take("rebuild", size, stop=self._stop)
                last: Exception | None = None
                t_o = 30 if factory_dl is None else factory_dl.cap(30)
                call_md = md
                if factory_dl is not None:
                    call_md = tuple(md or ()) + (
                        (_op_deadline.DEADLINE_HEADER,
                         factory_dl.header_value()),
                    )
                for url in urls:
                    try:
                        data = b"".join(
                            r.data
                            for r in rpc.volume_stub(channel(url)).VolumeEcShardRead(
                                pb.VolumeEcShardReadRequest(
                                    volume_id=vid,
                                    shard_id=sid,
                                    offset=offset,
                                    size=size,
                                ),
                                timeout=t_o,
                                metadata=call_md,
                            )
                        )
                    except grpc.RpcError as e:
                        last = e
                        continue
                    if len(data) == size:
                        return data
                    last = ValueError(
                        f"shard {sid}@{url} returned {len(data)} of {size} "
                        f"bytes at {offset}"
                    )
                raise last or ValueError(f"no holder for ec shard {sid}")

            return read

        def closer() -> None:
            for ch in channels.values():
                ch.close()

        return (
            {sid: make_reader(sid, urls) for sid, urls in locations.items()},
            closer,
        )

    def VolumeEcShardsBatchRebuild(self, req, context):
        """Rebuild N volumes' missing shards, batched: volumes whose
        survivors are all local and whose missing shards are missing
        cluster-wide ride one MeshCodec decode round per tile
        (ec_files.rebuild_ec_files_batch, grouped there by damage
        signature; K2). Volumes that don't fit that shape (a "missing"
        shard is mounted elsewhere, or survivors must be rack-gathered)
        fall through to the single-volume rebuild per volume, so the
        verb is safe to aim at any mix. Reuses the BatchGenerate message
        pair: ids in, empty response (rebuilt ids are logged; callers
        recompute presence, as ec.rebuild does)."""
        with trace.span(
            "volume.ec_rebuild_batch",
            header=trace.header_from_grpc_context(context),
            node=f"{self.host}:{self.port}",
        ) as sp:
            if sp:
                sp.annotate("vids", list(req.volume_ids))
            batch: list[tuple[int, str]] = []
            for vid in req.volume_ids:
                ev = self.store.find_ec_volume(vid)
                base = (
                    ev.base_name
                    if ev is not None
                    else self._base_name("", vid)
                )
                present, missing = ec_files.shard_presence(base)
                if not missing:
                    continue
                remote = self._cluster_present_shards(vid)
                if (
                    sum(present) >= ec_files.DATA_SHARDS
                    and not (set(missing) & remote)
                ):
                    batch.append((vid, base))
                else:
                    self._ec_shards_rebuild(
                        pb.VolumeEcShardsRebuildRequest(volume_id=vid),
                        context,
                    )
            if batch:
                st: dict = {}
                try:
                    ec_files.rebuild_ec_files_batch(
                        [base for _, base in batch],
                        codec=self._batch_codec(),
                        durable=True,
                        stats=st,
                        want_crcs=True,
                    )
                except ValueError as e:
                    context.abort(
                        grpc.StatusCode.FAILED_PRECONDITION, str(e)
                    )
                for (vid, base), crcs in zip(
                    batch, st.get("shard_crcs") or []
                ):
                    self._log_rebuild_crcs(vid, base, {"shard_crcs": crcs})
        return pb.VolumeEcShardsBatchGenerateResponse()

    def _cluster_present_shards(self, vid: int) -> set[int]:
        """Shard ids of `vid` mounted on other nodes per the master:
        shards the batch rebuild must not regenerate locally (the single
        verb's _remote_rebuild_readers exclusion, presence only). Empty
        with no master or on a failed lookup; then every locally missing
        shard is a target, as in the single verb on those arms."""
        if not self.master:
            return set()
        try:
            with rpc.dial(self._master_grpc()) as ch:
                resp = rpc.master_stub(ch).LookupEcVolume(
                    master_pb2.LookupEcVolumeRequest(volume_id=vid),
                    timeout=5,
                )
        except grpc.RpcError:
            return set()
        me = self._self_urls()
        return {
            e.shard_id
            for e in resp.shard_id_locations
            if any(l.url not in me for l in e.locations)
        }

    @staticmethod
    def _publish_ecc(base: str, crcs) -> None:
        """Publish/refresh the `.ecc` scrub sidecar (ec/ecc_sidecar.py)
        from encode/rebuild-pass CRCs. Callers reach here only on the
        durable=True arms, so the shard bytes the sidecar attests are
        already fsynced — the ordering the weedcrash ecc_publish
        workload enforces. Best-effort: a sidecar we fail to write
        just means the scrubber takes the (loud) parity path."""
        from seaweedfs_tpu_torch.ec import ecc_sidecar

        if not ecc_sidecar.ecc_enabled():
            return
        try:
            ecc_sidecar.write_sidecar(
                base, crcs, total_shards=ec_files.TOTAL_SHARDS
            )
        except OSError as e:
            wlog.warning("ec: .ecc sidecar publish failed for %s: %r", base, e)

    def _log_rebuild_crcs(self, vid: int, base: str, st: dict) -> None:
        """Operator breadcrumb: encode-pass CRC-32C of every rebuilt
        shard file (fused out of the codec pass — see the generate
        verb), keyed so a later scrub mismatch can be triaged against
        what the rebuild actually produced. Also merges the fresh CRCs
        into the volume's `.ecc` sidecar: rebuilt shards are
        byte-identical to the originals, so the merge re-attests them
        and un-stales the sidecar's mtime in one publish."""
        crcs = st.get("shard_crcs")
        if crcs:
            wlog.info(
                "ec.rebuild vid=%s rebuilt_crc32c=%s",
                vid,
                ",".join(f"{i}:{c:08x}" for i, c in sorted(crcs.items())),
            )
            self._publish_ecc(base, dict(crcs))

    def VolumeEcShardsCopy(self, req: pb.VolumeEcShardsCopyRequest, context):
        """Pull shard files (and with copy_ecx_file the .ecx and the
        optional .ecj) from the source node via its CopyFile stream."""
        target_dir = self.store.locations[0].directory
        base = volume_base_name(target_dir, req.collection, req.volume_id)
        host, _, port = req.source_data_node.partition(":")
        with rpc.dial(f"{host}:{int(port) + 10000}") as ch:
            stub = rpc.volume_stub(ch)
            exts = [ec_files.to_ext(sid) for sid in req.shard_ids]
            if req.copy_ecx_file:
                exts += [".ecx", ".ecj"]
            for ext in exts:
                try:
                    with open(base + ext, "wb") as f:
                        for resp in stub.CopyFile(
                            pb.CopyFileRequest(
                                volume_id=req.volume_id,
                                collection=req.collection,
                                ext=ext,
                                is_ec_volume=True,
                            )
                        ):
                            f.write(resp.file_content)
                except grpc.RpcError:
                    os.remove(base + ext)
                    if ext != ".ecj":  # .ecj is optional
                        raise
        return pb.VolumeEcShardsCopyResponse()

    def VolumeEcShardsDelete(self, req, context):
        base = self._base_name(req.collection, req.volume_id)
        for sid in req.shard_ids:
            p = base + ec_files.to_ext(sid)
            if os.path.exists(p):
                os.remove(p)
        # when no shards remain, drop the index files too
        if not any(
            os.path.exists(base + ec_files.to_ext(i)) for i in range(14)
        ):
            for ext in (".ecx", ".ecj"):
                if os.path.exists(base + ext):
                    os.remove(base + ext)
        return pb.VolumeEcShardsDeleteResponse()

    def VolumeEcShardsMount(self, req, context):
        self.store.mount_ec_shards(req.volume_id, req.collection, list(req.shard_ids))
        return pb.VolumeEcShardsMountResponse()

    def VolumeEcShardsUnmount(self, req, context):
        self.store.unmount_ec_shards(req.volume_id, list(req.shard_ids))
        return pb.VolumeEcShardsUnmountResponse()

    def VolumeEcShardRead(self, req: pb.VolumeEcShardReadRequest, context):
        # tracing: the trace context rides gRPC invocation metadata so a
        # remote shard read parents under the requesting hop's span and
        # keeps its plane tag (a scrub/repair-driven read stays visibly
        # scrub/repair traffic on THIS node's ring too)
        with trace.span(
            "volume.ec_shard_read",
            header=trace.header_from_grpc_context(context),
            nbytes=req.size,
            node=f"{self.host}:{self.port}",
        ) as sp:
            ev = self.store.find_ec_volume(req.volume_id)
            if ev is None:
                context.abort(grpc.StatusCode.NOT_FOUND, f"ec volume {req.volume_id} not found")
            shard = ev.shards.get(req.shard_id)
            remote = ev.remote
            if shard is None and not (
                remote is not None and req.shard_id in remote.shards
            ):
                context.abort(
                    grpc.StatusCode.NOT_FOUND,
                    f"ec shard {req.volume_id}.{req.shard_id} not mounted",
                )
            if sp:
                sp.annotate("vid", req.volume_id)
                sp.annotate("shard", req.shard_id)
            if req.file_key:
                # tombstone check against .ecj-backed index state
                try:
                    ev.locate_needle(req.file_key)
                except NeedleNotFound:
                    yield pb.VolumeEcShardReadResponse(is_deleted=True)
                    return
            if shard is None:
                # tiered-away shard: peers keep fetching through this
                # node (the shard map still routes here — the heartbeat
                # advertises serving_shard_ids), and this node streams
                # the sub-range from its attached backend
                info = remote.shards[req.shard_id]
                size = int(info.get("size", remote.shard_size))
                remaining = min(req.size, max(0, size - req.offset))
                offset = req.offset
                while remaining > 0:
                    chunk = ev._remote_fetch(
                        req.shard_id, offset, min(COPY_CHUNK, remaining)
                    )
                    if not chunk:
                        context.abort(
                            grpc.StatusCode.UNAVAILABLE,
                            f"tier backend read failed for ec shard "
                            f"{req.volume_id}.{req.shard_id}",
                        )
                    yield pb.VolumeEcShardReadResponse(data=chunk)
                    offset += len(chunk)
                    remaining -= len(chunk)
                return
            # clamp the span to the shard: read_at treats past-EOF reads as
            # truncation (it guards the DEGRADED path, where short data must
            # never silently substitute), but a plain span read walking the
            # shard end — ec.verify's tile probe — just gets what exists
            remaining = min(req.size, max(0, shard.size - req.offset))
            offset = req.offset
            while remaining > 0:
                chunk = shard.read_at(offset, min(COPY_CHUNK, remaining))
                if not chunk:
                    break  # never spin yielding empties
                yield pb.VolumeEcShardReadResponse(data=chunk)
                offset += len(chunk)
                remaining -= len(chunk)

    def VolumeEcBlobDelete(self, req, context):
        ev = self.store.find_ec_volume(req.volume_id)
        if ev is not None:
            ev.delete_needle(req.file_key)
        return pb.VolumeEcBlobDeleteResponse()

    def VolumeEcShardsToVolume(self, req, context):
        """Decode mounted shards back into a normal volume
        (volume_grpc_erasure_coding.go:329)."""
        ev = self.store.find_ec_volume(req.volume_id)
        if ev is None:
            context.abort(grpc.StatusCode.NOT_FOUND, f"ec volume {req.volume_id} not found")
        base = ev.base_name
        # ensure all shards present locally
        missing = [i for i in range(14) if i not in ev.shards]
        if missing:
            ec_files.rebuild_ec_files(base, rs=self._new_rs())
        ec_files.write_idx_file_from_ec_index(base)
        dat_size = ec_files.find_dat_file_size(base, ev.version)
        with open(base + ".dat", "wb") as out:
            written = 0
            while written < dat_size:
                chunk = min(4 * 1024 * 1024, dat_size - written)
                out.write(
                    ec_files.read_shard_intervals(base, written, chunk, dat_size)
                )
                written += chunk
        self.store.unmount_ec_shards(req.volume_id, list(range(14)))
        loc = self.store.locations[0]
        from seaweedfs_tpu_torch.storage.volume import Volume

        loc.volumes[req.volume_id] = Volume(
            os.path.dirname(base) or ".", req.volume_id, req.collection, create=False
        )
        return pb.VolumeEcShardsToVolumeResponse()

    # ------------------------------------------------------------------
    # experimental select-from-files (volume_grpc_query.go:12)
    def Query(self, req, context):
        raise NotImplementedError(
            "Query needs the query engine (ROADMAP item 11)"
        )

    # ------------------------------------------------------------------
    # tiered storage (volume_grpc_tier_upload.go:14 / tier_download.go)
    def VolumeTierMoveDatToRemote(self, req, context):
        """Copy a sealed volume's .dat to a remote backend, streaming
        progress; the volume then serves reads via ranged GETs."""
        v = self.store.find_volume(req.volume_id)
        if v is None:
            context.abort(
                grpc.StatusCode.NOT_FOUND, f"volume {req.volume_id} not found"
            )
        if v.collection != req.collection:
            context.abort(
                grpc.StatusCode.FAILED_PRECONDITION,
                f"existing collection {v.collection!r} != {req.collection!r}",
            )
        updates: list = []

        def progress(done: int, pct: float) -> None:
            updates.append((done, pct))

        try:
            v.tier_upload(
                req.destination_backend_name,
                keep_local=req.keep_local_dat_file,
                progress=progress,
            )
        except (RuntimeError, OSError) as e:
            context.abort(grpc.StatusCode.FAILED_PRECONDITION, str(e))
        for done, pct in updates:
            yield pb.VolumeTierMoveDatToRemoteResponse(
                processed=done, processed_percentage=pct
            )

    def VolumeTierMoveDatFromRemote(self, req, context):
        """Bring a tiered volume's .dat back to local disk."""
        v = self.store.find_volume(req.volume_id)
        if v is None:
            context.abort(
                grpc.StatusCode.NOT_FOUND, f"volume {req.volume_id} not found"
            )
        if v.collection != req.collection:
            context.abort(
                grpc.StatusCode.FAILED_PRECONDITION,
                f"existing collection {v.collection!r} != {req.collection!r}",
            )
        updates: list = []

        def progress(done: int, pct: float) -> None:
            updates.append((done, pct))

        try:
            v.tier_download(
                keep_remote=req.keep_remote_dat_file, progress=progress
            )
        except (RuntimeError, OSError) as e:
            context.abort(grpc.StatusCode.FAILED_PRECONDITION, str(e))
        for done, pct in updates:
            yield pb.VolumeTierMoveDatFromRemoteResponse(
                processed=done, processed_percentage=pct
            )

    # ------------------------------------------------------------------
    # remote shard fetches for degraded reads (store_ec.go:211-359)
    _EC_LOC_TTL_UNHEALTHY = 11.0
    _EC_LOC_TTL_DEGRADED = 7 * 60.0
    _EC_LOC_TTL_FULL = 37 * 60.0

    def _cached_lookup_ec_locations(self, ev) -> None:
        """Refresh ev.shard_locations from the master when stale
        (cachedLookupEcShardLocations, store_ec.go:218-259)."""
        now = time.time()
        with ev.shard_locations_lock:
            count = len(ev.shard_locations)
            age = now - ev.shard_locations_refresh_time
            if count >= 14:
                ttl = self._EC_LOC_TTL_FULL
            elif count >= 10:
                ttl = self._EC_LOC_TTL_DEGRADED
            else:
                ttl = self._EC_LOC_TTL_UNHEALTHY
            if age < ttl:
                return
        if not self.master:
            return
        try:
            with rpc.dial(self._master_grpc()) as ch:
                resp = rpc.master_stub(ch).LookupEcVolume(
                    master_pb2.LookupEcVolumeRequest(volume_id=ev.volume_id),
                    timeout=5,
                )
        except grpc.RpcError:
            return
        with ev.shard_locations_lock:
            for entry in resp.shard_id_locations:
                ev.shard_locations[entry.shard_id] = [
                    l.url for l in entry.locations
                ]
            ev.shard_locations_refresh_time = time.time()

    @staticmethod
    def _forget_shard_id(ev, shard_id: int) -> None:
        """Drop a shard's cached locations after a failed read; the
        refresh clock is zeroed so the NEXT fetch re-learns them from
        the master (forgetShardId, store_ec.go:211-216) instead of one
        dropped connection blinding every reconstruction for a TTL."""
        with ev.shard_locations_lock:
            ev.shard_locations.pop(shard_id, None)
            ev.shard_locations_refresh_time = 0.0

    def _scrub_shard_fetcher(self, ev):
        """The scrub engine's fetcher: _remote_shard_fetcher after asking
        the master again when a shard is neither mounted here nor cached
        on another holder. A holder that quarantined a shard, or met it
        quarantined elsewhere, keeps such an entry (itself, or none)
        after the shard is rebuilt on another server, and the
        reference's engine, whose fetcher then never reaches the master
        within the cache's TTL (7 or 37 minutes), stops every pass over
        the volume at that shard."""
        me = self._self_urls()
        with ev.shard_locations_lock:
            if any(sid not in ev.shards
                   and not [u for u in ev.shard_locations.get(sid, []) if u not in me]
                   for sid in range(ev.rs.total_shards)):
                ev.shard_locations_refresh_time = 0.0
        return self._remote_shard_fetcher(ev)

    def _remote_shard_fetcher(self, ev):
        """fetch(shard_id, offset, size) against the EC volume's cached
        shard locations, forgetting locations whose reads fail: the
        `fetch` seam of EcVolume.read_needle. Safe to call concurrently
        (the reconstruction fan-out runs one fetch per missing shard in
        parallel)."""
        # refresh once up front: the reconstruction fan-out calls
        # fetch() from up to 13 threads at once, and each doing its own
        # cold-cache LookupEcVolume would hammer the master
        self._cached_lookup_ec_locations(ev)
        # the fan-out threads have no ambient span or deadline: capture
        # both here so each remote read parents under this request and
        # times out within what remains of its budget
        md = trace.grpc_metadata()
        factory_dl = _op_deadline.current()

        def read_from(url: str, shard_id: int, offset: int, size: int):
            host, _, port = url.partition(":")
            try:
                t_o = 10 if factory_dl is None else factory_dl.cap(10)
            except _op_deadline.DeadlineExceeded:
                return None  # budget spent: the gather fails, fast
            call_md = md
            if factory_dl is not None:
                call_md = tuple(md or ()) + (
                    (_op_deadline.DEADLINE_HEADER,
                     factory_dl.header_value()),
                )
            # two tries per holder: a flaky link kills individual
            # connections, and a fresh dial usually succeeds
            for attempt in range(2):
                try:
                    with rpc.dial(f"{host}:{int(port) + 10000}") as ch:
                        chunks = [
                            r.data
                            for r in rpc.volume_stub(ch).VolumeEcShardRead(
                                pb.VolumeEcShardReadRequest(
                                    volume_id=ev.volume_id,
                                    shard_id=shard_id,
                                    offset=offset,
                                    size=size,
                                ),
                                timeout=t_o,
                                metadata=call_md,
                            )
                        ]
                    return b"".join(chunks)
                except grpc.RpcError:
                    continue
            return None

        def fetch(shard_id: int, offset: int, size: int):
            me = self._self_urls()
            for round_ in range(2):
                with ev.shard_locations_lock:
                    urls = list(ev.shard_locations.get(shard_id, []))
                attempted = False
                for url in urls:
                    if url in me:
                        continue
                    attempted = True
                    data = read_from(url, shard_id, offset, size)
                    if data is not None:
                        return data
                if attempted:
                    self._forget_shard_id(ev, shard_id)
                if round_ == 0:
                    # forgetting zeroed the refresh clock: re-learn the
                    # holders from the master NOW and give the shard one
                    # more chance inside this same request
                    self._cached_lookup_ec_locations(ev)
            return None

        return fetch

    # ------------------------------------------------------------------
    # HTTP data path
    def _commit_write(self, vid: int, n, stages: dict | None = None):
        """The one write seam behind do_POST's Python path: (size,
        unchanged) via the group committer when one is installed
        (docs/QOS.md — batched pwritev + shared fsync window), else the
        classic per-needle store write."""
        if self.group_commit is None:
            return self.store.write_needle(vid, n, stages=stages)
        v = self.store.find_volume(vid)
        if v is None:
            raise NeedleNotFound(f"volume {vid} not found")
        _, size, unchanged = self.group_commit.write(v, n, stages=stages)
        return size, unchanged

    def _http_handler_class(self):
        server = self

        class Handler(FastHandler):
            def _reply(self, status, body=b"", headers=None):
                self.fast_reply(status, body, headers)

            def _json(self, obj, status=200):
                self._reply(status, json.dumps(obj).encode(), _JSON_HDR)

            def _parse_fid(self):
                """(FileId, query, filename, ext) from any of the
                reference's addressing forms (common.go:152
                parseURLPath + needle.go:149 ParsePath — comma/slash
                forms, optional extension and filename, `_delta`
                appendix fids). (None, None, "", "") = unparseable."""
                path, _, qs = self.path.partition("?")
                vid, fid_str, filename, ext, vid_only = parse_url_path(path)
                if vid_only or not fid_str:
                    return None, None, "", ""
                try:
                    return parse_path_fid(vid, fid_str), fast_query(qs), filename, ext
                except ValueError:
                    return None, None, "", ""

            def _check_write_auth(self) -> bool:
                """True = allowed; shared candidate/claim logic lives in
                write_path.check_write_auth (the -shardWrites workers
                run the same check on their local writes)."""
                err = write_path.check_write_auth(
                    server.guard, self.path, self.headers,
                    self.client_address[0],
                )
                if err is None:
                    return True
                self._json({"error": err}, 401)
                return False

            def do_GET(self):
                url_path = self.path.partition("?")[0]
                if url_path in ("/", "/ui/index.html"):
                    return self._reply(
                        200,
                        server._render_ui().encode(),
                        {"Content-Type": "text/html; charset=utf-8"},
                    )
                if url_path == "/status":
                    from seaweedfs_tpu_torch import images

                    hb = server.store.collect_heartbeat()
                    return self._json(
                        {
                            "Version": "seaweedfs_tpu",
                            "Volumes": len(hb.volumes),
                            "EcVolumes": len(hb.ec_shards),
                            # scrub plane: quarantined shards are no
                            # longer silent — operators (and the shell's
                            # scrub.status) see them here, the master
                            # sees them via ScrubStat heartbeat rows
                            # list() snapshots: the scrub thread (or a
                            # foreground quarantine) mutates these dicts
                            # concurrently with this handler thread
                            "QuarantinedShards": {
                                str(vid): sorted(list(per_vid))
                                for vid, per_vid in list(
                                    server.store.quarantined.items()
                                )
                            },
                            "Scrub": (
                                server.scrub.status()
                                if server.scrub is not None
                                else {"Disabled": True}
                            ),
                            # health plane (docs/HEALTH.md): local
                            # degradation state; no handoff spool
                            # without the replica fan-out (item 10)
                            "LameDuck": server.watchdog.lame_duck,
                            "Draining": server.draining,
                            "IoErrors": server.watchdog.io_errors,
                            "HandoffPending": {},
                            "Resizing": (
                                "enabled"
                                if images.resizing_enabled()
                                else "disabled"
                            ),
                            # C serving-edge counters: the C core is not
                            # ported (ROADMAP item 5), so empty, as the
                            # reference reports them without it
                            "ServeStats": {},
                        }
                    )
                if url_path == "/scrub/status":
                    if server.scrub is None:
                        return self._json({"Disabled": True})
                    return self._json(server.scrub.status())
                if url_path == "/scrub/trigger":
                    # operator surface (scrub.trigger shell command):
                    # kick a sweep now, optionally one volume first
                    if server.scrub is None:
                        return self._json({"error": "scrub disabled"}, 400)
                    q = fast_query(self.path.partition("?")[2])
                    vid_arg = q.get("volumeId", "")
                    try:
                        vid = int(vid_arg) if vid_arg else None
                    except ValueError:
                        return self._json(
                            {"error": f"bad volumeId {vid_arg!r}"}, 400
                        )
                    server.scrub.trigger(vid)
                    return self._json({"triggered": True, "volumeId": vid})
                if url_path == "/tier/status":
                    # lifecycle tiering (docs/TIERING.md): per-volume
                    # local/remote shard state + mtimes — the master's
                    # TierScheduler polls this for its age signal
                    from seaweedfs_tpu_torch.tier.ec_tier import tier_status

                    return self._json(tier_status(server.store))
                if url_path == "/ec/quarantine":
                    # operator surface (and tests/faults.DeadShard): put
                    # one mounted EC shard out of service NOW — the
                    # degraded-read drill lever (docs/SCRUB.md); same
                    # rename-to-.bad path the scrubber takes, so the
                    # repair plane regenerates it like real damage
                    q = fast_query(self.path.partition("?")[2])
                    try:
                        vid = int(q.get("volumeId", ""))
                    except ValueError:
                        return self._json({"error": "bad volumeId"}, 400)
                    ev = server.store.find_ec_volume(vid)
                    if ev is None:
                        return self._json(
                            {"error": f"ec volume {vid} not here"}, 404
                        )
                    sid_arg = q.get("shard", "")
                    try:
                        sid = int(sid_arg) if sid_arg else ev.shard_ids()[0]
                    except (ValueError, IndexError):
                        return self._json({"error": "bad shard"}, 400)
                    ok = ev.quarantine_shard(sid, "operator: /ec/quarantine")
                    return self._json(
                        {"volumeId": vid, "shard": sid, "quarantined": ok}
                    )
                if url_path == "/metrics":
                    from seaweedfs_tpu_torch.stats.metrics import DEFAULT_REGISTRY

                    body = DEFAULT_REGISTRY.render_text().encode()
                    self.send_response(200)
                    self.send_header("Content-Type", "text/plain; version=0.0.4")
                    self.send_header("Content-Length", str(len(body)))
                    self.end_headers()
                    return self.wfile.write(body)
                # stage timings for the traced threaded GET arm, named
                # identically to the C fast path's SERVE_STAGES
                # (parse/resolve/send) so a blackbox wide-event reads
                # the same whichever arm served it (the weedscope twin
                # of the POST arm's parse/assemble/crc/pwrite/reply)
                req_span = getattr(self, "_trace_span", None)
                stages = {} if req_span is not None else None
                t_stage = time.perf_counter() if stages is not None else 0.0
                fid, q, url_filename, url_ext = self._parse_fid()
                if stages is not None:
                    now_pc = time.perf_counter()
                    stages["parse"] = now_pc - t_stage
                    t_stage = now_pc

                def _staged_exit(status, body=b"", headers=None, obj=None):
                    # error/redirect/not-modified exits carry the same
                    # stage fields as the C fast path (resolve ends at
                    # the verdict, send covers the reply write): a 404
                    # wide-event reads identically on both arms
                    if stages is None:
                        if obj is not None:
                            return self._json(obj, status)
                        return self._reply(status, body, headers)
                    t_send = time.perf_counter()
                    stages["resolve"] = t_send - t_stage
                    if obj is not None:
                        self._json(obj, status)
                    else:
                        self._reply(status, body, headers)
                    stages["send"] = time.perf_counter() - t_send
                    req_span.add_stages(stages)

                if fid is None:
                    return _staged_exit(400, obj={"error": "invalid file id"})
                if self.headers.get(qos.HEDGE_HEADER):
                    # QoS plane: a tied (hedged) read — count it and tag
                    # the span so trace.dump shows which arm this was;
                    # if the client's other attempt wins, its socket
                    # close is the cancel (the reply write fails and
                    # this connection tears down quietly)
                    from seaweedfs_tpu_torch.stats.metrics import HEDGE_SERVED

                    HEDGE_SERVED.labels("volume").inc()
                    hedge_span = getattr(self, "_trace_span", None)
                    if hedge_span is not None:
                        hedge_span.annotate("hedge", 1)
                try:
                    v = server.store.find_volume(fid.volume_id)
                    if v is not None:
                        n = v.read_needle(fid.key, cookie=fid.cookie)
                    else:
                        ev = server.store.find_ec_volume(fid.volume_id)
                        if ev is None:
                            # not local: redirect the reader to an owning
                            # node (volume_server_handlers_read.go:60-77)
                            target = server._redirect_target(fid.volume_id)
                            if target:
                                return _staged_exit(
                                    302,
                                    b"",
                                    {"Location": f"http://{target}{self.path}"},
                                )
                            return _staged_exit(
                                404, obj={"error": "volume not found"}
                            )
                        # intervals on shards held elsewhere are fetched
                        # from their holders; lost ones are decoded from
                        # local and fetched survivors on the card
                        n = ev.read_needle(
                            fid.key, fetch=server._remote_shard_fetcher(ev)
                        )
                        if n.cookie != fid.cookie:
                            raise CookieMismatch("cookie mismatch")
                except NeedleNotFound:
                    return _staged_exit(404)
                except CookieMismatch:
                    return _staged_exit(404)
                except NotEnoughShards as e:
                    return _staged_exit(500, obj={"error": str(e)})
                except OSError as e:
                    # disk watchdog (docs/HEALTH.md): EIO on the read
                    # path strikes toward lame-duck mode; a 500 beats a
                    # silently torn connection either way
                    if not server.watchdog.note_io_error(e):
                        raise
                    return _staged_exit(
                        500, obj={"error": f"read failed: {e}"}
                    )
                # serve-first: stamp the arbiter so background planes
                # (rebuild/replication/handoff/tier) yield to foreground
                # reads; the per-volume counter is the tier scheduler's
                # access-temperature signal (scraped via /metrics)
                get_arbiter().note_serve()
                VOLUME_READS.labels(str(fid.volume_id)).inc()
                if n.is_chunked_manifest():
                    return self._serve_chunked_manifest(n)
                # conditional gets: If-Modified-Since (RFC 1123, like
                # the reference's time.Parse(http.TimeFormat) check at
                # volume_server_handlers_read.go:102-112) and ETag
                if n.has_last_modified_date():
                    ims = self.headers.get("if-modified-since")
                    if ims:
                        from email.utils import parsedate_to_datetime

                        try:
                            t = parsedate_to_datetime(ims).timestamp()
                        except (TypeError, ValueError):
                            t = None
                        if t is not None and t >= n.last_modified:
                            return _staged_exit(304)
                data = bytes(n.data)
                if self.headers.get("etag-md5") == "True":
                    # opt-in md5 validator (crc.go:33 n.MD5 + ETag-MD5);
                    # picked BEFORE the If-None-Match compare so md5
                    # revalidations can actually 304
                    import hashlib

                    etag = f'"{hashlib.md5(data).hexdigest()}"'
                else:
                    etag = f'"{n.etag()}"'
                # RFC 9110 §13.1.2: weak validators (W/"…"), comma
                # lists, and `*` all revalidate — not just the exact
                # strong match (the C fast path's weed_etag_match runs
                # the same scanner; the identity tests diff them)
                if etag_matches(self.headers.get("If-None-Match", ""), etag):
                    return _staged_exit(304)
                headers = {"ETag": etag, "Content-Type": "application/octet-stream"}
                # URL filename wins; else the stored name; ext feeds the
                # mime guess and the resizer (read handler :138-150)
                fname = url_filename
                if not fname and n.has_name() and n.name:
                    fname = n.name.decode("latin-1")
                ext = url_ext or (os.path.splitext(fname)[1] if fname else "")
                if n.has_mime() and n.mime and not n.mime.startswith(
                    b"application/octet-stream"
                ):
                    headers["Content-Type"] = n.mime.decode("latin-1")
                elif ext:
                    import mimetypes

                    guessed = mimetypes.types_map.get(ext.lower())
                    if guessed:
                        headers["Content-Type"] = guessed
                if fname:
                    disp = "inline"
                    if q.get("dl", "").lower() in ("true", "1"):
                        disp = "attachment"
                    escaped = fname.replace("\\", "\\\\").replace('"', '\\"')
                    headers["Content-Disposition"] = (
                        f'{disp}; filename="{escaped}"'
                    )
                if n.has_last_modified_date():
                    headers["Last-Modified"] = _http_date(n.last_modified)
                if n.has_pairs() and n.pairs:
                    # stored extended pairs surface as response headers
                    # (read handler :123-133) — minus framing headers a
                    # hostile uploader could use to desync keep-alive
                    try:
                        pair_obj = json.loads(n.pairs)
                        items = (
                            pair_obj.items() if isinstance(pair_obj, dict) else ()
                        )
                        for k, pv in items:
                            if str(k).lower() in (
                                "content-length", "connection",
                                "transfer-encoding", "content-encoding",
                            ):
                                continue
                            headers[str(k)] = str(pv)
                    except ValueError:
                        pass
                try:
                    width = int(q.get("width", "0") or 0)
                    height = int(q.get("height", "0") or 0)
                except ValueError:
                    width = height = 0
                if n.is_gzipped() and ext != ".gz":
                    # stored-gzipped: pass through to gzip-accepting
                    # clients, transparently decompress for the rest
                    # (read handler :152-162); an explicit .gz URL gets
                    # the raw bytes. Resizes always decompress — the
                    # resizer needs pixels, not a gzip stream.
                    if (
                        not (width or height)
                        and "gzip" in self.headers.get("accept-encoding", "")
                    ):
                        headers["Content-Encoding"] = "gzip"
                    else:
                        from seaweedfs_tpu_torch.util.compression import try_gunzip

                        decoded = try_gunzip(data)
                        if decoded is data:
                            wlog.warning("ungzip %s: corrupt stream", self.path)
                        data = decoded
                # on-read image resizing (?width=&height=&mode=,
                # volume_server_handlers_read.go:224 images.Resized);
                # unparseable dims serve the original, as the reference
                if width or height:
                    rext = ext
                    if not rext and headers["Content-Type"].startswith("image/"):
                        rext = "." + headers["Content-Type"].split("/")[1]
                    from seaweedfs_tpu_torch import images

                    if images.is_image_ext(rext):
                        data, _, _ = images.resized(rext, data, width, height, q.get("mode", ""))
                        headers.pop("ETag", None)  # derived variant
                if stages is None:
                    return self._serve_maybe_ranged(data, headers)
                now_pc = time.perf_counter()
                stages["resolve"] = now_pc - t_stage
                self._serve_maybe_ranged(data, headers)
                stages["send"] = time.perf_counter() - now_pc
                req_span.add_stages(stages)

            def _serve_maybe_ranged(self, data: bytes, headers: dict):
                """Full 200 or single-range 206 per the Range header
                (volume_server_handlers_read.go serves ranges via
                http.ServeContent; suffix and open-ended forms too).
                Takes OWNERSHIP of `headers` (callers pass a fresh
                per-request dict, never a shared constant): no-Range
                requests — the hot read path — mutate it in place
                instead of copying."""
                rng = self.headers.get("range")
                if not rng:
                    headers["Accept-Ranges"] = "bytes"
                    return self._reply(200, data, headers)
                from seaweedfs_tpu_torch.util.http_range import (
                    RangeNotSatisfiable,
                    parse_range,
                )

                headers = dict(headers)
                headers["Accept-Ranges"] = "bytes"
                total = len(data)
                try:
                    span = parse_range(rng, total)
                except RangeNotSatisfiable:
                    return self._reply(
                        416, b"", {"Content-Range": f"bytes */{total}"}
                    )
                if span is None:
                    return self._reply(200, data, headers)
                start, end = span
                headers["Content-Range"] = f"bytes {start}-{end}/{total}"
                self._reply(206, data[start : end + 1], headers)

            def _serve_chunked_manifest(self, n: Needle):
                """Chunk-manifest fan-in: stream each chunk fid in offset
                order without buffering the whole file
                (volume_server_handlers_read.go:171, ChunkedFileReader)."""
                raw = _needle_manifest_bytes(n)
                chunks = _parse_manifest_chunks(raw)
                if chunks is None:
                    return self._json({"error": "invalid chunk manifest"}, 500)
                manifest = json.loads(raw)
                # Content-Length must match what we actually stream, so
                # it comes from the validated chunk sizes, never the
                # client-declared manifest "size"
                total = sum(c["size"] for c in chunks)
                headers = {"Content-Type": "application/octet-stream"}
                if manifest.get("mime"):
                    headers["Content-Type"] = manifest["mime"]
                if manifest.get("name"):
                    headers["Content-Disposition"] = (
                        f'inline; filename="{manifest["name"]}"'
                    )
                self.send_response(200)
                for k, v in headers.items():
                    self.send_header(k, v)
                self.send_header("Content-Length", str(total))
                self.end_headers()
                if self.command == "HEAD":
                    return
                for c in chunks:
                    piece = server._fetch_fid(c["fid"])
                    if piece is None:
                        # headers already sent; truncate the connection so
                        # the client sees a short read, not silent corruption
                        self.close_connection = True
                        return
                    self.wfile.write(piece)

            do_HEAD = do_GET

            def _shed_unwritable(self) -> bool:
                """weedguard graceful degradation (docs/HEALTH.md):
                a lame-duck (disk watchdog tripped) or draining node
                sheds NEW writes with 503 + Retry-After — reads keep
                flowing, the master has already stopped assigning
                here, and (with the replica fan-out, ROADMAP item
                10) a healthy primary turns the 503 into a handoff
                hint instead of a failed write."""
                if not (server.watchdog.lame_duck or server.draining):
                    return False
                why = (
                    "lame-duck (disk errors)"
                    if server.watchdog.lame_duck
                    else "draining"
                )
                self._reply(
                    503,
                    json.dumps(
                        {"error": f"node is read-only: {why}"}
                    ).encode(),
                    _JSON_HDR + b"Retry-After: 1\r\n",
                )
                return True

            def _tier_move(self):
                """POST /tier/move?volumeId=&direction=out|in
                [&destination=type.id] — the TierScheduler's (and
                tier.move shell command's) verb. Runs the move inline
                under the request's ambient deadline; the engine
                charges the bandwidth arbiter's "tier" claimant as
                bytes stream, so a scan-wide fan-in cannot stampede."""
                from seaweedfs_tpu_torch.tier import ec_tier
                from seaweedfs_tpu_torch.tier.rules import tier_enabled

                if not tier_enabled():
                    return self._json(
                        {"error": "tiering disabled (WEED_TIER=0)"}, 403
                    )
                q = fast_query(self.path.partition("?")[2])
                try:
                    vid = int(q.get("volumeId", ""))
                except ValueError:
                    return self._json({"error": "bad volumeId"}, 400)
                direction = q.get("direction", "out")
                try:
                    if direction == "out":
                        dest = q.get("destination", "")
                        if not dest:
                            return self._json(
                                {"error": "destination required"}, 400
                            )
                        result = ec_tier.tier_out_ec(
                            server.store, vid, dest, stop=server._stop
                        )
                    elif direction == "in":
                        result = ec_tier.tier_in_ec(
                            server.store, vid, stop=server._stop
                        )
                    else:
                        return self._json(
                            {"error": f"bad direction {direction!r}"}, 400
                        )
                except (ValueError, KeyError) as e:
                    return self._json({"error": str(e)}, 404)
                except (OSError, RuntimeError) as e:
                    return self._json({"error": str(e)}, 500)
                return self._json(result)

            def do_POST(self):
                if self.path.partition("?")[0] == "/tier/move":
                    return self._tier_move()
                fid, q, url_filename, _url_ext = self._parse_fid()
                if fid is None:
                    return self._json({"error": "invalid file id"}, 400)
                if not self._check_write_auth():
                    return
                if self._shed_unwritable():
                    return
                # serve-first: foreground writes also push background
                # planes (rebuild/replication/handoff/tier) into their
                # yield window
                get_arbiter().note_serve()
                length = int(self.headers.get("content-length", "0"))
                body = self.rfile.read(length)
                # the tracing plane's parse/assemble/crc/pwrite/reply
                # stages, attached to the mini loop's volume.post span
                # (handed to us as _trace_span by serve_connection). The
                # reference's one-pass C POST loop is not ported
                # (ROADMAP item 8); this is its byte-identical Python arm.
                req_span = getattr(self, "_trace_span", None)
                stages = {} if req_span is not None else None
                n, fname, err = write_path.build_upload_needle(
                    fid,
                    q,
                    body,
                    self.headers,
                    url_filename,
                    server.fix_jpg_orientation,
                    stages=stages,
                )
                if err is not None:
                    return self._json({"error": err}, 400)
                try:
                    size, unchanged = server._commit_write(
                        fid.volume_id, n, stages=stages
                    )
                except NeedleNotFound:
                    return self._json({"error": "volume not found"}, 404)
                except (VolumeReadOnly, CookieMismatch) as e:
                    return self._json({"error": str(e)}, 409)
                except OSError as e:
                    if not server.watchdog.note_io_error(e):
                        raise
                    return self._json(
                        {"error": f"write failed: {e}"}, 500
                    )
                t_reply = time.perf_counter() if stages is not None else 0.0
                reply = (
                    b'{"name": %s, "size": %d, "eTag": "%s"}'
                    % (_esc_json(fname).encode(), size, n.etag().encode())
                )
                if stages is not None:
                    stages["reply"] = time.perf_counter() - t_reply
                if stages:
                    req_span.add_stages(stages)
                if q.get("type") != "replicate":
                    err = server._replicate(fid, q, "POST", body, self.headers)
                    if err:
                        return self._json({"error": err}, 500)
                self._reply(201, reply, _JSON_HDR)

            def do_DELETE(self):
                fid, q, _fn, _ext = self._parse_fid()
                if fid is None:
                    return self._json({"error": "invalid file id"}, 400)
                if not self._check_write_auth():
                    return
                if self._shed_unwritable():
                    return
                n = Needle(cookie=fid.cookie, id=fid.key)
                try:
                    v = server.store.find_volume(fid.volume_id)
                    if v is not None:
                        existing = v.read_needle(fid.key, cookie=fid.cookie)
                        size = server.store.delete_needle(fid.volume_id, n)
                    else:
                        ev = server.store.find_ec_volume(fid.volume_id)
                        if ev is None:
                            return self._json({"error": "volume not found"}, 404)
                        # same cookie gate as the normal-volume branch
                        existing = ev.read_needle(
                            fid.key,
                            fetch=server._remote_shard_fetcher(ev),
                        )
                        if existing.cookie != fid.cookie:
                            raise CookieMismatch("cookie mismatch")
                        ev.delete_needle(fid.key)
                        size = 0
                except NeedleNotFound:
                    return self._json({"size": 0}, 404)
                except CookieMismatch as e:
                    return self._json({"error": str(e)}, 409)
                if existing.is_chunked_manifest():
                    # cascade: delete every chunk the manifest points at
                    # (volume_server_handlers_write.go DeleteHandler)
                    for c in _parse_manifest_chunks(_needle_manifest_bytes(existing)) or []:
                        server._delete_fid(c["fid"])
                if q.get("type") != "replicate":
                    err = server._replicate(
                        fid, q, "DELETE", b"", self.headers
                    )
                    if err:
                        return self._json({"error": err}, 500)
                self._json({"size": size}, 202)

        return Handler

    def _self_urls(self) -> set[str]:
        """Every address the master may report THIS server under: the
        bind address and (with `announce`) the advertised one.
        Self-exclusion checks must match both, or an announced primary
        would replicate every write to itself through its own hop."""
        me = {f"{self.host}:{self.port}"}
        me.add(f"{self.announce_host}:{self.announce_port}")
        return me

    def _redirect_target(self, vid: int) -> str | None:
        """Another server that can serve this vid: a replica holder, or
        any EC shard holder learned from the master."""
        if not self.master:
            # standalone: no one to ask (the reference's server raises
            # in its handler here and drops the connection; the port
            # answers its no-owner 404)
            return None
        me = self._self_urls()
        for url in self._lookup_locations(vid) or []:
            if url not in me:
                return url
        try:
            with rpc.dial(self._master_grpc()) as ch:
                resp = rpc.master_stub(ch).LookupEcVolume(
                    master_pb2.LookupEcVolumeRequest(volume_id=vid)
                )
            for entry in resp.shard_id_locations:
                for loc in entry.locations:
                    if loc.url != me:
                        return loc.url
        except grpc.RpcError:
            pass
        return None

    def _fetch_fid(self, fid_str: str) -> bytes | None:
        """Resolve a chunk fid (local store first, then master lookup +
        HTTP GET from the owning peer)."""
        import urllib.request

        try:
            fid = FileId.parse(fid_str)
        except ValueError:
            return None
        v = self.store.find_volume(fid.volume_id)
        if v is not None:
            try:
                n = v.read_needle(fid.key, cookie=fid.cookie)
            except (NeedleNotFound, CookieMismatch):
                return None
            if n.is_gzipped():
                from seaweedfs_tpu_torch.util.compression import try_gunzip

                return try_gunzip(bytes(n.data))
            return n.data
        if not self.master:
            return None
        for url in self._lookup_locations(fid.volume_id) or []:
            try:
                # weedlint: ignore[no-deadline] — single bounded 10 s replica hop, as the reference's chunk fetch
                with urllib.request.urlopen(f"http://{url}/{fid_str}", timeout=10) as r:
                    return r.read()
            except OSError:
                continue
        return None

    def _delete_fid(self, fid_str: str) -> None:
        """Cascade-delete one chunk fid through the HTTP DELETE path so
        the handler's replication fan-out reaches every replica (a
        local-only store delete would orphan replica copies)."""
        import urllib.request

        try:
            fid = FileId.parse(fid_str)
        except ValueError:
            return
        mine = self._self_urls()
        urls = []
        if self.master:
            urls = [u for u in (self._lookup_locations(fid.volume_id) or [])
                    if u not in mine]
        if self.store.find_volume(fid.volume_id) is not None:
            # dial ourselves by the BIND address, never the announced
            # hop (and never twice)
            urls = [f"{self.host}:{self.port}"] + urls
        for url in urls:
            try:
                req = urllib.request.Request(f"http://{url}/{fid_str}", method="DELETE")
                if self.guard is not None and self.guard.signing_key:
                    # server-initiated cascade: sign our own write token
                    req.add_header(
                        "Authorization", f"BEARER {self.guard.sign_write(fid_str)}"
                    )
                # weedlint: ignore[no-deadline] — single bounded 10 s replica-delete hop; the cascade itself is the retry surface
                urllib.request.urlopen(req, timeout=10).read()
                return
            except OSError:
                continue

    def _replicate(self, fid: FileId, q: dict, method: str, body: bytes, headers) -> str | None:
        """Fan the write to replica peers (store_replicate.go:44-80):
        all-or-error. A peer that fails fails the write, and the client
        gets the error, never an acknowledgement with fewer copies than
        the volume's placement asks for. (The reference spools such a
        write as a handoff hint unless WEED_HANDOFF=0; the spool waits
        for ROADMAP item 10, so the port always takes the WEED_HANDOFF=0
        arm.)

        Fewer holders than the placement's copy count also fail the
        write, as SeaweedFS's store_replicate.go does ("replicating
        operations [n] is less than volume replication copy count"):
        once the master has dropped a dead peer, the reference's Python
        server acknowledges the write with the copies that are left."""
        v = self.store.find_volume(fid.volume_id)
        if v is None:
            return None
        copies = v.super_block.replica_placement.copy_count
        if copies <= 1 or not self.master:
            return None
        all_locations = self._lookup_locations(fid.volume_id)
        if all_locations is None:
            return "replication lookup failed"
        mine = self._self_urls()
        locations = [u for u in dict.fromkeys(all_locations) if u not in mine]
        if len(locations) + 1 < copies:
            return (
                f"replicating operations [{len(locations) + 1}] is less than "
                f"volume {fid.volume_id} replication copy count [{copies}]"
            )
        return write_path.replicate_to_peers(
            fid, q, method, body, headers, locations
        )

    def start(self) -> None:
        self._grpc_pool = futures.ThreadPoolExecutor(max_workers=32)
        self._grpc_server = grpc.server(self._grpc_pool)
        self._grpc_server.add_generic_rpc_handlers(
            (rpc.servicer_handler(rpc.VOLUME_SERVICE, rpc.VOLUME_METHODS, self),)
        )
        rpc.add_port(self._grpc_server, f"{self.host}:{self.grpc_port}")
        self._grpc_server.start()
        from seaweedfs_tpu_torch.util.httpd import ReusePortWeedHTTPServer

        handler = self._http_handler_class()
        server_cls = ReusePortWeedHTTPServer if self.reuse_port else WeedHTTPServer
        self._http_server = server_cls((self.host, self.port), handler)
        # tracing plane: the mini request loop mints/inherits a span per
        # request, labeled with this daemon's role and address
        self._http_server.trace_name = "volume"
        self._http_server.trace_node = f"{self.host}:{self.port}"
        # the knobs bound keep-alive lifetimes on the mini loop
        self._http_server.serve_idle_ms = self.serve_idle_ms
        self._http_server.serve_max_reqs = self.serve_max_reqs
        # QoS plane: the mini loop counts in-flight dispatches (heartbeat
        # load signal) and runs per-client admission when configured
        self._http_server.load_tracker = self.load
        self._http_server.admission = self.admission
        threading.Thread(target=self._http_server.serve_forever, daemon=True).start()
        if self.master:
            self._hb_thread = threading.Thread(
                target=self._heartbeat_loop, daemon=True, name="volume-heartbeat"
            )
            self._hb_thread.start()
        # telemetry plane: continuous sampling profiler behind
        # /debug/profile (WEED_PROF=0 opts out)
        from seaweedfs_tpu_torch.telemetry import profiler

        self._profiling = profiler.ensure_started()
        if self.scrub is not None:
            self.scrub.start()

    def drain(self, timeout: float = 30.0) -> None:
        """SIGTERM graceful drain (docs/HEALTH.md runbook): announce
        `draining` on an immediate beat — the master excludes this node
        from write assignment — shed new writes with 503, let in-flight
        requests finish (bounded by `timeout`), then stop(): the
        heartbeat stream teardown deregisters the node cleanly."""
        self.draining = True
        self._hb_wake.set()  # the flag rides the NEXT beat, now
        wlog.warning(
            "volume %s:%d draining: writes shed, waiting for %d "
            "in-flight request(s)", self.host, self.port,
            self.load.inflight(),
        )
        deadline = time.time() + timeout
        if self.master:
            # one beat RTT so the master sees the flag before we exit
            time.sleep(min(2 * self.heartbeat_interval, 2.0))
        while time.time() < deadline and self.load.inflight() > 0:
            time.sleep(0.05)
        self.stop()

    def stop(self) -> None:
        """Stop serving and close the store. Every thread start() made
        has ended when this returns: the listeners, the heartbeat stream
        (its end is what unregisters this node at the master) and the
        metrics push loop, the gRPC workers (grpc's own stop leaves its
        executor's threads alive), this server's hold on the sampling
        profiler, the scrub engine's sweeper and the parked workers of
        the degraded gathers' pool."""
        self._stop.set()
        self._hb_wake.set()  # unblock the heartbeat generator's wait
        if self.scrub is not None:
            self.scrub.stop()
        if self._hb_thread is not None:
            self._hb_thread.join(timeout=30)
            self._hb_thread = None
        self._stop_metrics_push()
        if self._http_server:
            self._http_server.shutdown()
            self._http_server.server_close()
        if self._grpc_server:
            rpc.stop_server(self._grpc_server, self._grpc_pool)
        if self._profiling:
            from seaweedfs_tpu_torch.telemetry import profiler

            profiler.release()
            self._profiling = False
        # the degraded gathers' attempt workers park between tasks; the
        # pool is the process's, so end the parked ones here (a server
        # still serving starts fresh ones on demand)
        from seaweedfs_tpu_torch.qos import hedge

        hedge.close_idle()
        self.store.close()
