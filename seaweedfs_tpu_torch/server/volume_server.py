"""Volume server: the data plane, on the port's store and EC codec.

The port of seaweedfs_tpu/server/volume_server.py as a standalone
server (no master): the HTTP blob path (POST, GET/HEAD with Range,
ETag and 304, DELETE), the status and metrics routes, the volume admin
verbs and the EC verb set over gRPC, with EC encode, rebuild and
degraded-read decodes on the card (`ec_codec="cuda"`, the default, on
`device`; "cpu" or "native" name a host codec).

What needs a part of the reference that the port does not have yet
raises NotImplementedError naming its ROADMAP item, at construction for
a parameter and at the call for a verb; it never silently does less:
the master (heartbeat, lookups, replica fan-out, redirects, remote
shard gathers; item 7), the scrub engine (item 9), the -workers
internal listener and write sharding (item 8), tier-move verbs
(item 9), the verbs that copy from peers (item 10), the batch EC verbs
(item 8) and Query (item 11). The reference's C serving core and C
POST path wait for items 5 and 8: requests run on the threaded mini
loop and the Python write path, the reference's own byte-identical
arms.
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
from seaweedfs_tpu_torch.util import wlog
from seaweedfs_tpu_torch.ec import ec_files
from seaweedfs_tpu_torch.ec.ec_volume import NotEnoughShards
from seaweedfs_tpu_torch.pb import rpc, volume_pb2 as pb
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
        # the planes the port does not have yet refuse up front, with
        # the reference's defaults kept (so scrub_interval must be 0)
        if master:
            raise NotImplementedError(
                "master: heartbeats, lookups and replica fan-out need the "
                "master tier (ROADMAP item 7)"
            )
        if scrub_interval > 0:
            raise NotImplementedError(
                "scrub_interval > 0: the scrub engine is not ported yet "
                "(ROADMAP item 9); pass scrub_interval=0"
            )
        if internal_port or shard_writes:
            raise NotImplementedError(
                "internal_port / shard_writes: the -workers processes are "
                "not ported yet (ROADMAP item 8)"
            )
        # what describes this node to a master and its peers, or runs
        # more writer processes: a value other than the reference's
        # default is refused, not ignored
        for name, value, default, plane in (
            ("public_url", public_url, "", "the master tier (ROADMAP item 7)"),
            ("data_center", data_center, "", "the master tier (ROADMAP item 7)"),
            ("rack", rack, "", "the master tier (ROADMAP item 7)"),
            ("announce", announce, "", "the master tier (ROADMAP item 7)"),
            ("heartbeat_interval", heartbeat_interval, 2.0,
             "the master tier (ROADMAP item 7)"),
            ("read_redirect", read_redirect, False, "the master tier (ROADMAP item 7)"),
            ("n_writers", n_writers, 1,
             "the -workers processes, not ported yet (ROADMAP item 8)"),
        ):
            if value != default:
                raise NotImplementedError(f"{name}={value!r} needs {plane}")
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
        self.guard = guard  # security.Guard; None = security off
        self.fix_jpg_orientation = fix_jpg_orientation
        self._grpc_server: grpc.Server | None = None
        self._grpc_pool: futures.ThreadPoolExecutor | None = None
        self._profiling = False
        self._http_server: WeedHTTPServer | None = None
        # SO_REUSEPORT on the public listener (the reference's -workers
        # read processes share the port through it)
        self.reuse_port = reuse_port
        # the scrub plane's engine is not ported (scrub_interval must be
        # 0); quarantine reporting (/status) still works — foreground
        # reads keep quarantining truncated shards
        self.store.node_label = f"{host}:{port}"
        self.scrub: "object | None" = None
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
        # node into read-only lame-duck mode on repeated EIO/ENOSPC (new
        # writes shed with 503), and SIGTERM sets `draining` (graceful
        # drain — see drain()). The hinted-handoff spool comes with the
        # replica fan-out that fills it (ROADMAP item 10).
        from seaweedfs_tpu_torch.cluster.health import DiskWatchdog

        self.watchdog = DiskWatchdog()
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
            "master: (none) &middot; "
            f"ec codec: {self.ec_codec or 'auto'}",
            ["Id", "Collection", "Size", "Files", "Deleted", "Mode"],
            "".join(rows),
            ["/status", "/metrics"],
        )

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
        raise NotImplementedError(
            "VolumeCopy pulls from a peer through the client and master "
            "(ROADMAP item 10)"
        )

    def CopyFile(self, req: pb.CopyFileRequest, context):
        raise NotImplementedError(
            "CopyFile serves the peer-copy verbs, which need the client "
            "and master (ROADMAP item 10)"
        )

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
        raise NotImplementedError(
            "VolumeTailSender follows a peer through the client and master "
            "(ROADMAP item 10)"
        )

    def VolumeTailReceiver(self, req, context):
        raise NotImplementedError(
            "VolumeTailReceiver pulls from a peer through the client and "
            "master (ROADMAP item 10)"
        )

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

    def VolumeEcShardsBatchGenerate(self, req, context):
        raise NotImplementedError(
            "VolumeEcShardsBatchGenerate: the batch EC verbs are not "
            "ported yet (ROADMAP item 8)"
        )

    def VolumeEcShardsRebuild(self, req, context):
        """Regenerate missing shard files from the local survivors (the
        reference also gathers survivors mounted on other servers, which
        needs the master: ROADMAP item 7)."""
        with trace.span(
            "volume.ec_rebuild",
            header=trace.header_from_grpc_context(context),
            node=f"{self.host}:{self.port}",
        ) as sp:
            if sp:
                sp.annotate("vid", req.volume_id)
            return self._ec_shards_rebuild(req, context)

    def _ec_shards_rebuild(self, req, context):
        """Every survivor is local on a standalone server: the classic
        local-file rebuild (the reference's no-master arm; gathering
        survivors from their holders needs the master, ROADMAP item 7)."""
        base = self._base_name(req.collection, req.volume_id)
        st: dict = {}
        rebuilt = ec_files.rebuild_ec_files(
            base, rs=self._new_rs(), durable=True, stats=st,
            want_crcs=True,
        )
        self._log_rebuild_crcs(req.volume_id, base, st)
        return pb.VolumeEcShardsRebuildResponse(rebuilt_shard_ids=rebuilt)

    def VolumeEcShardsBatchRebuild(self, req, context):
        raise NotImplementedError(
            "VolumeEcShardsBatchRebuild: the batch EC verbs are not "
            "ported yet (ROADMAP item 8)"
        )

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
        raise NotImplementedError(
            "VolumeEcShardsCopy pulls shards from a peer through the client "
            "and master (ROADMAP item 10)"
        )

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
        raise NotImplementedError(
            "VolumeTierMoveDatToRemote needs the tier engine (ROADMAP item 9)"
        )

    def VolumeTierMoveDatFromRemote(self, req, context):
        raise NotImplementedError(
            "VolumeTierMoveDatFromRemote needs the tier engine (ROADMAP item 9)"
        )

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
                    # the scrub engine is not ported: the reference's
                    # scrub-disabled answer
                    return self._json({"error": "scrub disabled"}, 400)
                if url_path == "/tier/status":
                    return self._json(
                        {"error": "lifecycle tiering is not ported yet "
                                  "(ROADMAP item 9)"},
                        501,
                    )
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
                            # not local, and no master to redirect to
                            # (the reference's no-owner answer)
                            return _staged_exit(
                                404, obj={"error": "volume not found"}
                            )
                        # lost shards are decoded from the local
                        # survivors (peer fetch needs the master)
                        n = ev.read_needle(fid.key)
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
                    piece = server._local_fid(c["fid"])
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

            def do_POST(self):
                if self.path.partition("?")[0] == "/tier/move":
                    return self._json(
                        {"error": "lifecycle tiering is not ported yet "
                                  "(ROADMAP item 9)"},
                        501,
                    )
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
                # replica fan-out learns its peers from the master
                # (ROADMAP item 7): a standalone server, the reference's
                # included, has none to write to
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
                        existing = ev.read_needle(fid.key)
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
                        server._delete_local_fid(c["fid"])
                self._json({"size": size}, 202)

        return Handler

    def _local_fid(self, fid_str: str) -> bytes | None:
        """A chunk fid's bytes from the local store (the reference also
        asks the master for a peer holder: ROADMAP item 7)."""
        try:
            fid = FileId.parse(fid_str)
        except ValueError:
            return None
        v = self.store.find_volume(fid.volume_id)
        if v is None:
            return None
        try:
            n = v.read_needle(fid.key, cookie=fid.cookie)
        except (NeedleNotFound, CookieMismatch):
            return None
        if n.is_gzipped():
            from seaweedfs_tpu_torch.util.compression import try_gunzip

            return try_gunzip(bytes(n.data))
        return n.data

    def _delete_local_fid(self, fid_str: str) -> None:
        """Cascade-delete one chunk fid through this server's own HTTP
        DELETE path (the reference also reaches the chunk's replicas
        through the master: ROADMAP item 7)."""
        import urllib.request

        try:
            fid = FileId.parse(fid_str)
        except ValueError:
            return
        if self.store.find_volume(fid.volume_id) is None:
            return
        req = urllib.request.Request(
            f"http://{self.host}:{self.port}/{fid_str}", method="DELETE"
        )
        if self.guard is not None and self.guard.signing_key:
            # server-initiated cascade: sign our own write token
            req.add_header(
                "Authorization", f"BEARER {self.guard.sign_write(fid_str)}"
            )
        try:
            # weedlint: ignore[no-deadline] — single bounded 10 s local hop, as the reference's cascade
            urllib.request.urlopen(req, timeout=10).read()
        except OSError:
            pass

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
        # telemetry plane: continuous sampling profiler behind
        # /debug/profile (WEED_PROF=0 opts out)
        from seaweedfs_tpu_torch.telemetry import profiler

        self._profiling = profiler.ensure_started()

    def drain(self, timeout: float = 30.0) -> None:
        """SIGTERM graceful drain (docs/HEALTH.md runbook): shed new
        writes with 503, let in-flight requests finish (bounded by
        `timeout`), then stop(). (The reference also announces
        `draining` to the master on a beat: ROADMAP item 7.)"""
        self.draining = True
        wlog.warning(
            "volume %s:%d draining: writes shed, waiting for %d "
            "in-flight request(s)", self.host, self.port,
            self.load.inflight(),
        )
        deadline = time.time() + timeout
        while time.time() < deadline and self.load.inflight() > 0:
            time.sleep(0.05)
        self.stop()

    def stop(self) -> None:
        """Stop serving and close the store. Every thread start() made
        has ended when this returns: the listeners, the gRPC workers
        (grpc's own stop leaves its executor's threads alive) and this
        server's hold on the sampling profiler."""
        if self._http_server:
            self._http_server.shutdown()
            self._http_server.server_close()
        if self._grpc_server:
            self._grpc_server.stop(grace=0.5).wait()
            self._grpc_pool.shutdown(wait=True)
        if self._profiling:
            from seaweedfs_tpu_torch.telemetry import profiler

            profiler.release()
            self._profiling = False
        self.store.close()
