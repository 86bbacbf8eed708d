"""Master server: cluster control plane over gRPC + HTTP.

Behavioral match of the reference master
(weed/server/master_server.go, master_grpc_server*.go,
master_server_handlers*.go):

  * gRPC Heartbeat stream: volume servers push full-state inventories;
    the master registers them in the Topology, answers with the volume
    size limit, and unregisters the node when the stream breaks —
    liveness IS the stream (SURVEY §5 failure detection);
  * gRPC KeepConnected: filers/shells hold this open and receive
    vid→location deltas as volumes appear/disappear;
  * HTTP /dir/assign /dir/lookup /submit /vol/grow /vol/vacuum
    /col/delete /cluster/status /stats/health — the public control API
    (master_server.go:108-121);
  * automatic volume growth when an assign finds no writable volume
    (AutomaticGrowByType), allocating on rack-aware placed nodes via
    the volume servers' AllocateVolume RPC.

Single-master build: the raft leader seam is `self.is_leader` plus the
IdGenerator behind Topology.next_volume_id (SURVEY §7 "simplest
possible leader election first, raft-compatible interface later");
with `peers` and `raft_dir`, cluster/raft.py replicates MaxVolumeId and
elects the leader.

The port of seaweedfs_tpu/server/master_server.py, with the repair
scheduler (`repair_interval > 0`, scrub/repair.py), the tier scheduler
(`tier_interval > 0`, tier/scheduler.py) and the cluster telemetry
collector (`telemetry_interval > 0`, telemetry/collector.py) with its
alert-triggered incident capsules. The etcd sequencer, which the port
does not have yet, raises NotImplementedError naming its ROADMAP item
(5). stop() ends every thread start() made.
"""

from __future__ import annotations

import functools
import json
import queue
import random
import threading
import time
from concurrent import futures

import grpc

from seaweedfs_tpu_torch import qos
from seaweedfs_tpu_torch.cluster import health as health_mod
from seaweedfs_tpu_torch.pb import master_pb2 as pb
from seaweedfs_tpu_torch.util.httpd import (
    JSON_HDR as _JSON_HDR,
    FastHandler,
    WeedHTTPServer,
    fast_query,
)
from seaweedfs_tpu_torch.pb import rpc, volume_pb2
from seaweedfs_tpu_torch.sequence import MemorySequencer
from seaweedfs_tpu_torch.storage.file_id import format_needle_id_cookie, parse_url_path
from seaweedfs_tpu_torch.storage.replica_placement import ReplicaPlacement
from seaweedfs_tpu_torch.storage.store import EcShardInfo, ScrubStatInfo, VolumeInfo
from seaweedfs_tpu_torch.storage.ttl import TTL
from seaweedfs_tpu_torch.topology import Topology
from seaweedfs_tpu_torch.util import wlog
from seaweedfs_tpu_torch.topology.volume_growth import (
    find_empty_slots_for_one_volume,
    find_volume_count,
)


@functools.lru_cache(maxsize=256)
def _canonical_rp(s: str) -> str:
    return str(ReplicaPlacement.parse(s))


@functools.lru_cache(maxsize=256)
def _canonical_ttl(s: str) -> str:
    return str(TTL.parse(s))


def _vol_info_from_pb(v: pb.VolumeStat) -> VolumeInfo:
    return VolumeInfo(
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


# /submit buffers its body in master memory; cap it (see _submit)
SUBMIT_MAX_BYTES = 256 * 1024 * 1024


class MasterServer:
    def __init__(
        self,
        host: str = "127.0.0.1",
        port: int = 9333,
        volume_size_limit_mb: int = 30 * 1024,
        default_replication: str = "000",
        garbage_threshold: float = 0.3,
        guard=None,
        peers: str | list | None = None,
        raft_dir: str | None = None,
        vacuum_interval: float = 15 * 60.0,
        node_timeout: float = 30.0,
        metrics_address: str = "",
        metrics_interval_sec: int = 15,
        sequencer=None,
        repair_interval: float = 0.0,
        repair_concurrency: int = 2,
        repair_grace: float = 30.0,
        telemetry_interval: float = 0.0,
        telemetry_kwargs: dict | None = None,
        tier_interval: float = 0.0,
        tier_kwargs: dict | None = None,
        assign_policy: str = "p2c",
    ):
        # QoS plane (docs/QOS.md): "p2c" = queue-depth-aware
        # power-of-two-choices over writable volumes; "random" keeps
        # the pre-QoS pure-random pick (-assignPolicy random; WEED_QOS=0
        # forces it wholesale)
        self.assign_policy = assign_policy
        self.host = host
        self.port = port
        self.grpc_port = port + 10000  # reference convention: http port + 10000
        self.topology = Topology(volume_size_limit_mb * 1024 * 1024)
        # sequencer: injected (e.g. EtcdSequencer for external-KV
        # coordination), else durable file-backed when the master has a
        # meta directory (etcd_sequencer.go role), else in-memory
        if sequencer is not None:
            self.sequencer = sequencer
        elif raft_dir:
            import os as _os

            from seaweedfs_tpu_torch.sequence import FileSequencer

            _os.makedirs(raft_dir, exist_ok=True)
            self.sequencer = FileSequencer(
                _os.path.join(raft_dir, f"sequencer-{port}.txt")
            )
        else:
            self.sequencer = MemorySequencer()
        self.default_replication = default_replication
        self.garbage_threshold = garbage_threshold
        self.guard = guard  # security.Guard; assign responses carry a jwt
        from seaweedfs_tpu_torch.stats import DurationCounter

        self.request_counter = DurationCounter()  # /stats/counter rolling UI
        # HA: peers (incl. self) => compact raft replicates MaxVolumeId
        # and elects the write coordinator (reference raft_server.go)
        self._raft = None
        peer_list = (
            [p.strip() for p in peers.split(",") if p.strip()]
            if isinstance(peers, str)
            else list(peers or [])
        )
        if peer_list:
            if not raft_dir:
                # without persisted term/vote a restarted master could
                # double-vote in a term it already voted in → split brain
                raise ValueError("peers requires raft_dir (persistent raft state)")
            from seaweedfs_tpu_torch.cluster.raft import RaftNode

            self._raft = RaftNode(
                f"{host}:{port}",
                peer_list,
                self._apply_cluster_command,
                data_dir=raft_dir,
            )
        self._vid_alloc_lock = threading.Lock()
        self._grow_lock = threading.Lock()
        self._vacuum_sweep_lock = threading.Lock()
        # leader-only periodic garbage-ratio vacuum sweep
        # (master_server.go:126 StartRefreshWritableVolumes); 0 disables
        self.vacuum_interval = vacuum_interval
        # liveness: unregister nodes silent for this long even if their
        # heartbeat STREAM never tore down (frozen process, half-open
        # TCP) — stream teardown alone leaves the master routing writes
        # to a dead node until kernel keepalive fires; 0 disables
        self.node_timeout = node_timeout
        # serializes node-membership transitions: the sweep's multi-step
        # unregister vs a Heartbeat handler's check-register-sync
        # sequence (never held across a yield)
        self._node_lock = threading.Lock()
        self._stop_event = threading.Event()
        # pushed down to volume servers in HeartbeatResponse
        # (master_grpc_server.go:80-84)
        self.metrics_address = metrics_address
        self.metrics_interval_sec = metrics_interval_sec
        self._clients: dict[int, queue.Queue] = {}
        self._clients_seq = 0
        self._clients_lock = threading.Lock()
        self._grpc_server: grpc.Server | None = None
        self._grpc_pool: futures.ThreadPoolExecutor | None = None
        self._http_server: WeedHTTPServer | None = None
        self._threads: list[threading.Thread] = []
        self._profiling = False
        # gateway registration (/cluster/register): filer/S3/WebDAV
        # announce themselves here so the collector can scrape them —
        # they have no heartbeat stream to be discovered from
        self._gateways: dict[str, dict] = {}
        self._gateways_lock = threading.Lock()
        # weedguard health plane (docs/HEALTH.md): per-node phi-accrual
        # suspicion + error EWMAs + lame-duck/drain flags, scored from
        # heartbeats. Always on (cheap); WEED_HEALTH=0 makes every
        # verdict read healthy, restoring pre-health behavior wholesale.
        self.health = health_mod.HealthPlane()
        # scrub plane: the automatic repair scheduler (scrub/repair.py).
        # repair_interval <= 0 leaves repair manual (ec.rebuild /
        # volume.fix.replication in the shell); the `weed` CLI enables
        # it by default — tests and embedders opt in explicitly because
        # automatic rebuilds mid-admin-operation are a real behavior
        # change.
        self.repair = None
        if repair_interval > 0:
            from seaweedfs_tpu_torch.scrub import RepairScheduler

            self.repair = RepairScheduler(
                self,
                interval=repair_interval,
                concurrency=repair_concurrency,
                grace=repair_grace,
            )
        # telemetry plane (docs/TELEMETRY.md): leader-only /metrics
        # scraper + ring TSDB + alert rules. telemetry_interval <= 0
        # leaves the plane off — the command line enables it by
        # default; tests and embedders opt in (a background scraper
        # hitting every node changes observable traffic).
        self.telemetry = None
        if telemetry_interval > 0:
            from seaweedfs_tpu_torch.telemetry import ClusterCollector

            self.telemetry = ClusterCollector(
                self, interval=telemetry_interval, **(telemetry_kwargs or {})
            )
            self._wire_capsules()
        # tiering plane (docs/TIERING.md): leader-only lifecycle
        # scheduler driving tier-out/tier-in moves at the shard
        # holders. tier_interval <= 0 leaves tiering manual (tier.move
        # in the shell) — same opt-in contract as repair/telemetry.
        self.tier = None
        if tier_interval > 0:
            from seaweedfs_tpu_torch.tier import TierScheduler

            self.tier = TierScheduler(
                self, interval=tier_interval, **(tier_kwargs or {})
            )

    def _wire_capsules(self) -> None:
        """weedscope (docs/TELEMETRY.md): leader-side capsule wiring.
        Firing alerts trigger a local capture plus remote captures on
        every implicated node, and the master's capsules grow the
        leader-only sections: the relevant TSDB window, the alert/SLO
        verdicts, and the health-plane snapshot."""
        from seaweedfs_tpu_torch.telemetry import capsule
        from seaweedfs_tpu_torch.trace import blackbox

        tel = self.telemetry

        def peers_for(alert_row: dict) -> list[str]:
            target = alert_row.get("Target", "")
            if ":" in target:  # node-scoped alert: that node is enough
                return [target]
            # cluster-scoped (SLO objective, repair depth): everyone
            # currently serving is implicated — fan the capture out
            return tel.up_targets()

        tel.alerts.on_fire = capsule.CaptureCoordinator(
            node=f"{self.host}:{self.port}",
            peers_fn=peers_for,
            enabled_fn=blackbox.enabled,
        )
        capsule.add_provider("tsdb", tel.window_payload)
        capsule.add_provider(
            "cluster",
            lambda: {
                "Alerts": tel.alerts.payload(),
                "SLO": tel.slo_payload(),
                "Health": tel.health_payload(),
            },
        )

    # gateways silent for this long stop being offered to the collector
    # (its own sticky-target window keeps their staleness alert alive
    # long before this prune runs)
    GATEWAY_TTL = 3600.0

    def register_gateway(self, kind: str, addr: str) -> None:
        with self._gateways_lock:
            self._gateways[addr] = {"kind": kind, "last_seen": time.time()}

    def gateway_registrations(self) -> dict[str, dict]:
        now = time.time()
        with self._gateways_lock:
            for addr in [
                a for a, row in self._gateways.items()
                if now - row["last_seen"] > self.GATEWAY_TTL
            ]:
                del self._gateways[addr]
            return {a: dict(r) for a, r in self._gateways.items()}

    @property
    def is_leader(self) -> bool:
        return self._raft.is_leader if self._raft else True

    def leader_address(self) -> str:
        hint = self._raft.leader() if self._raft else ""
        return hint or f"{self.host}:{self.port}"

    def _apply_cluster_command(self, cmd: dict) -> None:
        """Raft state machine (cluster_commands.go MaxVolumeIdCommand)."""
        if cmd.get("name") == "MaxVolumeId":
            self.topology.id_gen.adjust_if_larger(int(cmd["maxVolumeId"]))

    def _next_volume_id(self) -> int:
        """Allocate the next volume id; with raft, the allocation is
        replicated to a majority before use (topology.go NextVolumeId →
        raft Do(MaxVolumeIdCommand))."""
        if self._raft is None:
            return self.topology.next_volume_id()
        with self._vid_alloc_lock:
            # a freshly elected leader may hold committed-but-unapplied
            # MaxVolumeId entries from the prior term; drain them before
            # peeking or the next vid could collide with an existing one
            self._raft.barrier()
            vid = self.topology.id_gen.peek() + 1
            self._raft.propose({"name": "MaxVolumeId", "maxVolumeId": vid})
            return vid

    # ------------------------------------------------------------------
    # location broadcast (master_grpc_server.go KeepConnected)
    def _broadcast(self, url: str, public_url: str, new_vids: list[int], deleted_vids: list[int]) -> None:
        msg = pb.VolumeLocationDelta(
            location=pb.VolumeLocation(
                url=url, public_url=public_url, new_vids=new_vids, deleted_vids=deleted_vids
            )
        )
        with self._clients_lock:
            for q in self._clients.values():
                q.put(msg)

    # ------------------------------------------------------------------
    # gRPC servicer methods (bound via rpc.servicer_handler)
    def Heartbeat(self, request_iterator, context):
        dn = None
        stream_token = object()
        was_detached = False
        need_full = False  # ask the node to resend its full inventory
        try:
            for req in request_iterator:
                if not self.is_leader:
                    # redirect before registering: a follower must not
                    # ingest the node (clients on KeepConnected would
                    # see the volume map flap on every redirect)
                    yield pb.HeartbeatResponse(
                        volume_size_limit=self.topology.volume_size_limit,
                        leader=self.leader_address(),
                    )
                    return
                # the whole check-register-sync sequence runs under the
                # node lock so the liveness sweep can't detach the node
                # between the parent check and the volume sync (which
                # would re-register volumes onto an orphan the sweep
                # never sees again); the lock is NOT held across yield
                with self._node_lock:
                    if dn is not None and dn.parent is None:
                        # the liveness sweep declared this node dead
                        # while the stream stayed open (frozen process
                        # that woke up): register afresh. Volume state
                        # repopulates on the node's next full beat
                        # (every _FULL_HEARTBEAT_EVERY cycles); until
                        # then the master routes nothing to it.
                        dn = None
                        was_detached = True
                    if dn is None:
                        dn = self.topology.register_data_node(
                            ip=req.ip,
                            port=req.port,
                            public_url=req.public_url,
                            data_center=req.data_center or "DefaultDataCenter",
                            rack=req.rack or "DefaultRack",
                            max_volumes=req.max_volume_count or 7,
                        )
                        existing = getattr(dn, "stream_token", None)
                        if (
                            was_detached
                            and existing is not None
                            and existing is not stream_token
                        ):
                            # we were swept AND another live stream has
                            # since registered this node: ours is the
                            # obsolete one — end it without stealing
                            # ownership (the finally's token check then
                            # leaves the live node alone)
                            return
                        # a fresh reconnect takes ownership; the stale
                        # stream's teardown must not unregister the
                        # live node
                        dn.stream_token = stream_token
                        if was_detached:
                            # we registered a blank node mid-stream: the
                            # node's delta beats are useless until it
                            # resends the full inventory
                            need_full = True
                    dn.last_seen = time.time()
                    # QoS plane: live load for queue-depth-aware
                    # assignment (pick_for_write power-of-two-choices)
                    dn.in_flight = req.in_flight_requests
                    dn.write_queue_depth = req.write_queue_depth
                    # health plane (docs/HEALTH.md): beat arrival time
                    # feeds the phi-accrual detector, the counters feed
                    # the error EWMA, and the node's own lame-duck /
                    # draining flags land here
                    self.health.observe_heartbeat(dn.url, req)
                    self.sequencer.set_max(req.max_file_key)
                    if req.volumes or req.has_no_volumes:
                        new, deleted = self.topology.sync_volumes(
                            dn, [_vol_info_from_pb(v) for v in req.volumes]
                        )
                        if new or deleted:
                            self._broadcast(
                                dn.url,
                                dn.public_url,
                                [v.id for v in new],
                                [v.id for v in deleted],
                            )
                    elif req.new_volumes or req.deleted_volumes:
                        # delta beat: O(changes) registration. Stat
                        # changes to already-registered volumes update
                        # layouts but must not spam KeepConnected
                        # clients as "new"
                        new = [_vol_info_from_pb(v) for v in req.new_volumes]
                        deleted = [
                            _vol_info_from_pb(v) for v in req.deleted_volumes
                        ]
                        truly_new = [
                            v.id for v in new if v.id not in dn.volumes
                        ]
                        self.topology.delta_sync_volumes(dn, new, deleted)
                        if truly_new or deleted:
                            self._broadcast(
                                dn.url,
                                dn.public_url,
                                truly_new,
                                [v.id for v in deleted],
                            )
                    if req.ec_shards or req.has_no_ec_shards:
                        self.topology.sync_ec_shards(
                            dn,
                            [
                                EcShardInfo(s.id, s.collection, s.ec_index_bits)
                                for s in req.ec_shards
                            ],
                        )
                    # scrub plane: every beat carries the node's full
                    # scrub-health snapshot (quarantines arrive on a
                    # FORCED delta beat, so damage lands here within
                    # one heartbeat RTT of detection)
                    def _damage_sig(stats):
                        # only the damage-relevant fields: scanned_bytes
                        # advances every beat during a sweep, so a
                        # whole-row comparison would re-trigger the
                        # scheduler once per heartbeat
                        return {
                            (k, s.corruptions_found, s.quarantined_shard_bits)
                            for k, s in stats.items()
                            if s.corruptions_found or s.quarantined_shard_bits
                        }

                    prev_sig = _damage_sig(dn.scrub_stats)
                    self.topology.sync_scrub_stats(
                        dn,
                        [
                            ScrubStatInfo(
                                volume_id=s.volume_id,
                                is_ec=s.is_ec,
                                last_sweep_unix=s.last_sweep_unix,
                                scanned_bytes=s.scanned_bytes,
                                corruptions_found=s.corruptions_found,
                                quarantined_shard_bits=s.quarantined_shard_bits,
                                last_error=s.last_error,
                            )
                            for s in req.scrub_stats
                        ],
                    )
                    new_sig = _damage_sig(dn.scrub_stats)
                    # disk-health signal for the health plane: this
                    # node's scrub rows currently report damage
                    self.health.observe_scrub(dn.url, bool(new_sig))
                    if (
                        self.repair is not None
                        and new_sig
                        and new_sig != prev_sig
                    ):
                        # a NEW damage report (not the same rows riding
                        # every beat): scan now, don't wait the tick
                        self.repair.trigger()
                    if need_full and (req.volumes or req.has_no_volumes):
                        need_full = False  # full inventory received
                yield pb.HeartbeatResponse(
                    volume_size_limit=self.topology.volume_size_limit,
                    leader=self.leader_address(),
                    metrics_address=self.metrics_address,
                    metrics_interval_seconds=self.metrics_interval_sec,
                    request_full_heartbeat=need_full,
                )
        finally:
            with self._node_lock:
                if (
                    dn is not None
                    and getattr(dn, "stream_token", None) is stream_token
                ):
                    vids = list(dn.volumes)
                    self.topology.unregister_data_node(dn)
                    self.health.note_dead(dn.url)
                    if vids:
                        self._broadcast(dn.url, dn.public_url, [], vids)

    def KeepConnected(self, request_iterator, context):
        with self._clients_lock:
            self._clients_seq += 1
            cid = self._clients_seq
            q: queue.Queue = queue.Queue()
            self._clients[cid] = q
        try:
            # ack first so clients learn the leader even on an empty
            # cluster (reference sends leader redirects the same way)
            q.put(pb.VolumeLocationDelta(leader=self.leader_address()))
            # seed: full current map
            for dn in self.topology.data_nodes():
                vids = list(dn.volumes) + list(dn.ec_shards)
                if vids:
                    q.put(
                        pb.VolumeLocationDelta(
                            location=pb.VolumeLocation(
                                url=dn.url, public_url=dn.public_url, new_vids=vids
                            )
                        )
                    )
            next(iter(request_iterator))  # hello
            while context.is_active():
                try:
                    yield q.get(timeout=1.0)
                except queue.Empty:
                    continue
        except StopIteration:
            pass
        finally:
            with self._clients_lock:
                self._clients.pop(cid, None)

    def Assign(self, req: pb.AssignRequest, context) -> pb.AssignResponse:
        try:
            result = self.assign(
                count=req.count or 1,
                replication=req.replication,
                collection=req.collection,
                ttl=req.ttl,
                data_center=req.data_center,
            )
        except Exception as e:  # noqa: BLE001 - error travels in-band
            return pb.AssignResponse(error=str(e))
        return pb.AssignResponse(
            fid=result["fid"],
            url=result["url"],
            public_url=result["publicUrl"],
            count=result["count"],
            auth=result.get("auth", ""),
        )

    def _proxy_to_leader_stub(self, wait: float = 3.0):
        """Stub on the leader, or None when this master IS the leader
        (master_server.go:151 proxyToLeader: followers hold no
        topology — volume servers heartbeat only the leader — so reads
        must be answered there). Waits out brief leaderless election
        windows instead of failing instantly."""
        deadline = time.time() + wait
        while True:
            leader = self.leader_address()
            known = self._raft is None or self._raft.leader()
            if leader == f"{self.host}:{self.port}" and known:
                return None  # we are the leader
            if leader != f"{self.host}:{self.port}" and known:
                ch = grpc.insecure_channel(rpc.grpc_address(leader))
                return ch, rpc.master_stub(ch)
            if time.time() >= deadline:
                return "unknown"
            # weedlint: ignore[hot-loop-sleep] — bounded 3 s leader-election wait; failing instantly would 503 every read during each election window
            time.sleep(0.05)

    def _proxy_or_abort(self, context, verb: str, req, timeout: float):
        """Follower-side leader proxy for read verbs: returns the
        leader's response, None when THIS master is the leader (caller
        answers locally), or aborts UNAVAILABLE — an empty local
        answer from a follower would poison clients silently."""
        proxied = self._proxy_to_leader_stub()
        if proxied == "unknown":
            context.abort(grpc.StatusCode.UNAVAILABLE, "no leader elected yet")
        if proxied is None:
            return None
        ch, stub = proxied
        try:
            return getattr(stub, verb)(req, timeout=timeout)
        except grpc.RpcError:
            context.abort(
                grpc.StatusCode.UNAVAILABLE,
                "leader unreachable from this follower",
            )
        finally:
            ch.close()

    def LookupVolume(self, req: pb.LookupVolumeRequest, context) -> pb.LookupVolumeResponse:
        if not self.is_leader:
            resp = self._proxy_or_abort(context, "LookupVolume", req, 10)
            if resp is not None:
                return resp
        out = pb.LookupVolumeResponse()
        for vid_str in req.vids:
            entry = out.vid_locations.add(vid=vid_str)
            try:
                vid = int(vid_str.split(",")[0])
            except ValueError:
                entry.error = f"unknown volume id {vid_str}"
                continue
            nodes = self.topology.lookup(req.collection, vid)
            if not nodes:
                entry.error = f"volume id {vid} not found"
                continue
            # health plane (docs/HEALTH.md): suspects ordered last AND
            # marked, so every client demotes them cluster-wide (the
            # per-process circuit breaker only learns from its own
            # timeouts) and the hedge driver fires eagerly
            for dn in self.health.order_nodes(nodes):
                entry.locations.add(
                    url=dn.url,
                    public_url=dn.public_url,
                    suspect=self.health.suspect(dn.url),
                )
        return out

    def LookupEcVolume(self, req: pb.LookupEcVolumeRequest, context) -> pb.LookupEcVolumeResponse:
        if not self.is_leader:
            resp = self._proxy_or_abort(context, "LookupEcVolume", req, 10)
            if resp is not None:
                return resp
        out = pb.LookupEcVolumeResponse(volume_id=req.volume_id)
        locs = self.topology.lookup_ec_shards(req.volume_id)
        if locs is None:
            context.abort(grpc.StatusCode.NOT_FOUND, f"ec volume {req.volume_id} not found")
        for shard_id, nodes in enumerate(locs.locations):
            if not nodes:
                continue
            entry = out.shard_id_locations.add(shard_id=shard_id)
            for dn in nodes:
                entry.locations.add(url=dn.url, public_url=dn.public_url)
        return out

    def Statistics(self, req: pb.StatisticsRequest, context) -> pb.StatisticsResponse:
        if not self.is_leader:
            resp = self._proxy_or_abort(context, "Statistics", req, 10)
            if resp is not None:
                return resp
        total = used = files = 0
        for dn in self.topology.data_nodes():
            for v in dn.volumes.values():
                if req.collection and v.collection != req.collection:
                    continue
                used += v.size
                files += v.file_count
        total = self.topology.max_volume_count() * self.topology.volume_size_limit
        return pb.StatisticsResponse(total_size=total, used_size=used, file_count=files)

    def CollectionList(self, req, context) -> pb.CollectionListResponse:
        return pb.CollectionListResponse(collections=sorted(self.topology.collections()))

    def CollectionDelete(self, req: pb.CollectionDeleteRequest, context):
        if not self.is_leader:
            resp = self._proxy_or_abort(context, "CollectionDelete", req, 30)
            if resp is not None:
                return resp
        for dn in self.topology.data_nodes():
            try:
                with rpc.dial(self._node_grpc(dn)) as ch:
                    rpc.volume_stub(ch).DeleteCollection(
                        volume_pb2.DeleteCollectionRequest(collection=req.name)
                    )
            except grpc.RpcError:
                pass
        return pb.CollectionDeleteResponse()

    def VolumeList(self, req, context) -> pb.VolumeListResponse:
        return pb.VolumeListResponse(
            topology_json=json.dumps(self._topology_dump()),
            volume_size_limit_mb=self.topology.volume_size_limit // (1024 * 1024),
        )

    def GetMasterConfiguration(self, req, context):
        return pb.GetMasterConfigurationResponse()

    # ------------------------------------------------------------------
    # assignment (master_server_handlers.go:96 dirAssignHandler)
    def assign(
        self,
        count: int = 1,
        replication: str = "",
        collection: str = "",
        ttl: str = "",
        data_center: str = "",
    ) -> dict:
        if not self.is_leader:
            # proxy to the leader (master_server.go:151 proxyToLeader):
            # clients may talk to any master; only the leader assigns
            return self._proxy_assign(
                count, replication, collection, ttl, data_center
            )
        # normalize to the same canonical forms heartbeat registration
        # uses, so both paths land in the same layout (memoized: the
        # same handful of strings arrive on every assign)
        rp = _canonical_rp(replication or self.default_replication)
        ttl = _canonical_ttl(ttl)
        if not self.topology.has_writable_volume(collection, rp, ttl):
            if self.topology.free_space() <= 0:
                raise RuntimeError("no free volumes left")
            with self._grow_lock:
                if not self.topology.has_writable_volume(collection, rp, ttl):
                    self.grow_volumes(collection, rp, ttl, data_center=data_center)
        vid, _, nodes = self.topology.pick_for_write(
            collection, rp, ttl, count,
            data_center=data_center,
            policy=self.assign_policy if qos.enabled("assign") else "random",
            # health plane (docs/HEALTH.md): prefer volumes whose
            # replicas are all assignable — suspects/lame-ducks/
            # draining nodes stop receiving writes as soon as the
            # master suspects them, not when requests start timing out
            health=self.health,
        )
        file_key = self.sequencer.next_file_id(count)
        cookie = random.randrange(1 << 32)
        fid = f"{vid},{format_needle_id_cookie(file_key, cookie)}"
        dn = nodes[0]
        result = {
            "fid": fid,
            "url": dn.url,
            "publicUrl": dn.public_url,
            "count": count,
        }
        if self.guard is not None and self.guard.signing_key:
            # write token scoped to the assigned fid, handed to the
            # client the way the reference's assign response carries
            # `auth` (security.GenJwt on the master side)
            result["auth"] = self.guard.sign_write(fid)
        return result

    def _node_grpc(self, dn) -> str:
        return f"{dn.ip}:{dn.port + 10000}"

    def grow_volumes(
        self, collection: str, replication: str, ttl: str, data_center: str = "", target_count: int = 0
    ) -> int:
        """AutomaticGrowByType (volume_growth.go:63)."""
        rp = ReplicaPlacement.parse(replication)
        replication = str(rp)
        ttl = str(TTL.parse(ttl))
        target = target_count or find_volume_count(rp.copy_count)
        grown = 0
        for _ in range(target):
            try:
                servers = find_empty_slots_for_one_volume(
                    self.topology, rp, data_center=data_center
                )
            except ValueError:
                break
            vid = self._next_volume_id()
            ok = True
            for dn in servers:
                try:
                    with rpc.dial(self._node_grpc(dn)) as ch:
                        rpc.volume_stub(ch).AllocateVolume(
                            volume_pb2.AllocateVolumeRequest(
                                volume_id=vid,
                                collection=collection,
                                replication=replication,
                                ttl=ttl,
                            ),
                            timeout=5,
                        )
                except grpc.RpcError as e:
                    ok = False
                    break
            if ok:
                # register immediately (volume_growth.go grow() does the
                # same; the next heartbeat confirms)
                layout = self.topology.get_layout(collection, replication, ttl)
                for dn in servers:
                    info = VolumeInfo(
                        id=vid,
                        size=0,
                        collection=collection,
                        file_count=0,
                        delete_count=0,
                        deleted_byte_count=0,
                        read_only=False,
                        replica_placement=rp.to_byte(),
                        version=3,
                        ttl=0,
                    )
                    dn.volumes[vid] = info
                    layout.register_volume(info, dn)
                grown += 1
        if grown == 0:
            raise RuntimeError("failed to grow any volume")
        return grown

    def _topology_dump(self) -> dict:
        return self.topology.to_map()

    # ------------------------------------------------------------------
    # HTTP (master_server_handlers.go)
    def _http_handler_class(self):
        server = self

        class Handler(FastHandler):
            def _html(self, body: str, status=200):
                self.fast_reply(
                    status,
                    body.encode(),
                    {"Content-Type": "text/html; charset=utf-8"},
                )

            def _json(self, obj, status=200):
                self.fast_reply(status, json.dumps(obj).encode(), _JSON_HDR)

            def do_GET(self):
                server.request_counter.add()
                path, _, qs = self.path.partition("?")
                q = fast_query(qs)
                if self.command == "POST" and path != "/submit":
                    # keep-alive hygiene: drain any request body now —
                    # an unread body would be parsed as the next
                    # request line on this connection (/submit reads
                    # its own body in _submit)
                    try:
                        n = int(self.headers.get("Content-Length", "0"))
                    except ValueError:
                        n = 0
                    if n > 64 << 20:
                        # nothing but /submit legitimately posts a large
                        # body here; don't buffer-drain unbounded data
                        self.close_connection = True
                        return self._json({"error": "request body too large"}, 413)
                    while n > 0:
                        chunk = self.rfile.read(min(n, 1 << 20))
                        if not chunk:
                            break
                        n -= len(chunk)
                if path == "/dir/assign":
                    return self._assign(q)
                if path == "/dir/lookup":
                    return self._lookup(q)
                if path in ("/", "/ui/index.html"):
                    return self._html(server._render_master_ui())
                if path == "/cluster/status":
                    return self._json(
                        {
                            "IsLeader": server.is_leader,
                            "Leader": server.leader_address(),
                            "Peers": server._raft.peers if server._raft else [],
                        }
                    )
                if path == "/dir/status":
                    return self._json({"Topology": server._topology_dump()})
                if path == "/stats/health":
                    return self._json({"ok": True})
                if path == "/cluster/register":
                    # gateway announce (telemetry/announce.py): record
                    # on the leader so the collector that scrapes is
                    # the one that knows the gateway exists. addr must
                    # LOOK like host:port — the collector will dial
                    # http://<addr>/metrics every cycle, so a free-form
                    # string would turn the leader into an arbitrary-
                    # URL fetcher (and a permanent bogus-alert source)
                    kind = q.get("kind", "")
                    addr = q.get("addr", "")
                    host, _, port_s = addr.rpartition(":")
                    if (
                        not kind
                        or len(kind) > 32
                        or not host
                        or len(addr) > 256
                        or not port_s.isdigit()
                        or not int(port_s) < 65536
                        or any(c in host for c in "/?#@ \t")
                    ):
                        return self._json(
                            {"error": "kind and addr (host:port) required"},
                            400,
                        )
                    if not server.is_leader:
                        return self._proxy_http_to_leader()
                    server.register_gateway(kind, addr)
                    return self._json({"ok": True})
                if path == "/node/drain":
                    # weedguard (docs/HEALTH.md): operator drain intent
                    # for one volume server — excluded from assignment
                    # immediately, and the RepairScheduler moves its
                    # volumes/EC shards off (the node.drain shell
                    # command drives + polls this). ?stop=1 cancels;
                    # ?status=1 is the READ-ONLY poll form (no
                    # re-marking, no scheduler wake — the shell's
                    # -wait loop would otherwise re-fire the mutation
                    # twice a second).
                    node = q.get("node", "")
                    if not node or ":" not in node:
                        return self._json(
                            {"error": "node=host:port required"}, 400
                        )
                    if not server.is_leader:
                        return self._proxy_http_to_leader()
                    stop = q.get("stop", "") in ("1", "true")
                    if q.get("status", "") not in ("1", "true"):
                        server.health.request_drain(node, stop=stop)
                        if server.repair is not None and not stop:
                            server.repair.trigger()
                    dn = next(
                        (
                            d
                            for d in server.topology.data_nodes()
                            if d.url == node
                        ),
                        None,
                    )
                    return self._json(
                        {
                            "node": node,
                            "draining": not stop,
                            "registered": dn is not None,
                            "volumes": len(dn.volumes) if dn else 0,
                            "ecShards": dn.ec_shard_count() if dn else 0,
                            "repairScheduler": server.repair is not None,
                        }
                    )
                if path in (
                    "/cluster/health",
                    "/cluster/alerts",
                    "/cluster/top",
                    "/cluster/slo",
                ):
                    if not server.is_leader:
                        # followers hold no topology and run no
                        # collector cycles (their local collector may
                        # even be disabled); the leader's aggregates
                        # are the cluster's — proxy BEFORE the
                        # disabled check so a follower never answers
                        # "Disabled" for a cluster whose leader is
                        # collecting fine
                        return self._proxy_http_to_leader()
                    if path == "/cluster/health":
                        # weedguard (docs/HEALTH.md): per-node health
                        # scores/states ride this surface even with the
                        # telemetry collector off — the health plane
                        # lives on heartbeats alone
                        payload = {"NodeHealth": server.health.payload()}
                        if server.telemetry is None:
                            payload["Disabled"] = True
                            payload["error"] = (
                                "telemetry collector disabled "
                                "on this master (-telemetryInterval 0)"
                            )
                        else:
                            payload.update(
                                server.telemetry.health_payload()
                            )
                        return self._json(payload)
                    if server.telemetry is None:
                        return self._json(
                            {
                                "Disabled": True,
                                "error": "telemetry collector disabled "
                                "on this master (-telemetryInterval 0)",
                            }
                        )
                    if path == "/cluster/alerts":
                        return self._json(server.telemetry.alerts.payload())
                    if path == "/cluster/slo":
                        # weedscope (docs/TELEMETRY.md): per-objective
                        # burn rates, budget remaining, and the soak
                        # scorecard — the cluster.slo shell surface
                        return self._json(server.telemetry.slo_payload())
                    try:
                        n = int(q.get("n", "10"))
                    except ValueError:
                        n = 10
                    return self._json(server.telemetry.top_payload(n))
                if path == "/repair/queue":
                    # scrub plane operator surface (repair.queue shell
                    # command): scheduler config, tracked damage with
                    # backoff state, and recent repair history
                    if server.repair is None:
                        return self._json(
                            {"Disabled": True, "Scrub": server.topology.scrub_summary()}
                        )
                    snap = server.repair.queue_snapshot()
                    snap["Scrub"] = server.topology.scrub_summary()
                    return self._json(snap)
                if path == "/cluster/tier":
                    # tiering plane operator surface (tier.status shell
                    # command): scheduler rules, in-flight moves, and
                    # recent move history (docs/TIERING.md)
                    if server.tier is None:
                        return self._json(
                            {
                                "Disabled": True,
                                "error": "tier scheduler disabled on "
                                "this master (-tierInterval 0)",
                            }
                        )
                    return self._json(server.tier.status_snapshot())
                if path == "/stats/counter":
                    return self._json(server.request_counter.snapshot())
                if path == "/stats/memory":
                    import resource

                    ru = resource.getrusage(resource.RUSAGE_SELF)
                    return self._json({"maxrss_kb": ru.ru_maxrss})
                if path == "/metrics":
                    from seaweedfs_tpu_torch.stats.metrics import DEFAULT_REGISTRY

                    body = DEFAULT_REGISTRY.render_text().encode()
                    self.send_response(200)
                    self.send_header(
                        "Content-Type", "text/plain; version=0.0.4"
                    )
                    self.send_header("Content-Length", str(len(body)))
                    self.end_headers()
                    return self.wfile.write(body)
                if path == "/vol/grow":
                    try:
                        count = server.grow_volumes(
                            q.get("collection", ""),
                            q.get("replication", server.default_replication),
                            q.get("ttl", ""),
                            data_center=q.get("dataCenter", ""),
                            target_count=int(q.get("count", "0")),
                        )
                        return self._json({"count": count})
                    except Exception as e:  # noqa: BLE001
                        return self._json({"error": str(e)}, 500)
                if path == "/col/delete":
                    return self._json({"error": "use gRPC CollectionDelete"}, 400)
                if path == "/submit":
                    return self._submit(q)
                if path == "/vol/vacuum":
                    return self._vol_vacuum(q)
                if path == "/vol/status":
                    return self._json(
                        {
                            "Version": "seaweedfs_tpu",
                            "Volumes": server.topology.to_volume_map(),
                        }
                    )
                # fallthrough: GET /<fid> on the master 301s to a
                # volume server holding it (master_server.go:121
                # redirectHandler) — the curl-the-master convenience
                redirected = self._redirect_fid(path, q)
                if redirected:
                    return
                self._json({"error": f"unknown path {path}"}, 404)

            def _redirect_fid(self, path, q) -> bool:
                vid_str, fid_str, _fn, _ext, _vo = parse_url_path(path)
                # isascii guard: str.isdigit() accepts unicode digits
                # that int() then rejects
                if not (vid_str.isascii() and vid_str.isdigit()) or not fid_str:
                    return False
                nodes = server.topology.lookup(
                    q.get("collection", ""), int(vid_str)
                )
                if not nodes:
                    self._json(
                        {"error": f"volume id {vid_str} not found"}, 404
                    )
                    return True
                # redirect readers at a non-suspect replica when one
                # exists (health plane, docs/HEALTH.md)
                healthy = [
                    dn for dn in nodes if not server.health.suspect(dn.url)
                ]
                dn = random.choice(healthy or nodes)
                target = f"http://{dn.public_url}{self.path}"
                self.fast_reply(301, b"", {"Location": target})
                return True

            do_POST = do_GET

            def _submit(self, q):
                """Assign + proxy upload in one call — the curl
                one-liner path (master_server.go:116 /submit →
                submitForClientHandler). Routes through the client
                submit op against this master, so auto-chunking
                (?maxMB=) and assign's leader proxying both apply."""
                from seaweedfs_tpu_torch.client.operation import submit_file
                from seaweedfs_tpu_torch.util.multipart import (
                    MalformedUpload,
                    parse_upload,
                )

                try:
                    length = int(self.headers.get("Content-Length", "0"))
                    max_mb = int(q.get("maxMB", "0") or "0")
                except ValueError:
                    return self._json(
                        {"error": "maxMB / Content-Length must be integers"},
                        400,
                    )
                if length > SUBMIT_MAX_BYTES:
                    # /submit buffers the upload in master memory before
                    # assign+proxy (the convenience path); bound it so a
                    # huge or malicious body can't OOM the control
                    # plane — bulk ingest belongs on the volume/filer
                    # data planes
                    return self._json(
                        {
                            "error": f"/submit caps uploads at "
                            f"{SUBMIT_MAX_BYTES >> 20} MiB; upload via "
                            "assign + volume POST (or the filer) instead"
                        },
                        413,
                    )
                body = self.rfile.read(length)
                try:
                    part = parse_upload(
                        body, self.headers.get("Content-Type", "")
                    )
                except MalformedUpload as e:
                    return self._json({"error": str(e)}, 400)
                try:
                    res = submit_file(
                        f"{server.host}:{server.port}",
                        q.get("filename", "") or part.filename,
                        part.data,
                        replication=q.get("replication", ""),
                        collection=q.get("collection", ""),
                        ttl=q.get("ttl", ""),
                        mime=part.mime,
                        max_mb=max_mb,
                    )
                except Exception as e:  # noqa: BLE001
                    return self._json({"error": str(e)}, 500)
                if res.error:
                    return self._json({"error": res.error}, 500)
                self._json(
                    {
                        "fileName": res.file_name,
                        "fid": res.fid,
                        "fileUrl": res.file_url,
                        "size": res.size,
                    }
                )

            def _vol_vacuum(self, q):
                """Force one garbage-ratio vacuum sweep now
                (master_server.go:117 /vol/vacuum); optional
                ?garbageThreshold= overrides the configured ratio.
                Followers proxy to the leader, who owns the topology."""
                if not server.is_leader:
                    return self._proxy_http_to_leader()
                try:
                    threshold = (
                        float(q["garbageThreshold"])
                        if "garbageThreshold" in q
                        else None
                    )
                except ValueError:
                    return self._json(
                        {"error": "garbageThreshold must be a float"}, 400
                    )
                try:
                    count = server._vacuum_once(threshold=threshold)
                except Exception as e:  # noqa: BLE001
                    return self._json({"error": str(e)}, 500)
                self._json(
                    {"vacuumed": count, "Topology": server._topology_dump()}
                )

            def _proxy_http_to_leader(self):
                from seaweedfs_tpu_torch.client.operation import http_call

                leader = server.leader_address()
                if not leader or leader == f"{server.host}:{server.port}":
                    return self._json({"error": "no leader to proxy to"}, 503)
                try:
                    status, headers, body = http_call(
                        "GET", f"{leader}{self.path}", timeout=630
                    )
                except Exception as e:  # noqa: BLE001
                    return self._json({"error": f"leader proxy: {e}"}, 502)
                self.send_response(status)
                self.send_header(
                    "Content-Type",
                    headers.get("Content-Type", "application/json"),
                )
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

            def _assign(self, q):
                try:
                    result = server.assign(
                        count=int(q.get("count", "1")),
                        replication=q.get("replication", ""),
                        collection=q.get("collection", ""),
                        ttl=q.get("ttl", ""),
                        data_center=q.get("dataCenter", ""),
                    )
                    self._json(result)
                except Exception as e:  # noqa: BLE001
                    self._json({"error": str(e)}, 500)

            def _lookup(self, q):
                vid_str = q.get("volumeId", "")
                try:
                    vid = int(vid_str.split(",")[0])
                except ValueError:
                    return self._json({"error": f"unknown volumeId {vid_str}"}, 400)
                nodes = server.topology.lookup(q.get("collection", ""), vid)
                if not nodes:
                    return self._json(
                        {"volumeId": vid_str, "error": "volume id not found"}, 404
                    )
                # suspects last + marked (health plane, docs/HEALTH.md)
                self._json(
                    {
                        "volumeId": vid_str,
                        "locations": [
                            {
                                "url": dn.url,
                                "publicUrl": dn.public_url,
                                "suspect": server.health.suspect(dn.url),
                            }
                            for dn in server.health.order_nodes(nodes)
                        ],
                    }
                )

        return Handler

    # ------------------------------------------------------------------
    def _proxy_assign(
        self, count, replication, collection, ttl, data_center
    ) -> dict:
        leader = self.leader_address()
        if leader == f"{self.host}:{self.port}":
            raise RuntimeError("no leader elected yet")
        with rpc.dial(rpc.grpc_address(leader)) as ch:
            resp = rpc.master_stub(ch).Assign(
                pb.AssignRequest(
                    count=count,
                    replication=replication,
                    collection=collection,
                    ttl=ttl,
                    data_center=data_center,
                ),
                timeout=10,
            )
        if resp.error:
            raise RuntimeError(resp.error)
        return {
            "fid": resp.fid,
            "url": resp.url,
            "publicUrl": resp.public_url,
            "count": resp.count,
            **({"auth": resp.auth} if resp.auth else {}),
        }


    # ------------------------------------------------------------------
    # status UI (server/master_ui/templates.go role)
    def _render_master_ui(self) -> str:
        import html as _html

        rows = []
        for dn in self.topology.data_nodes():
            rack = dn.parent.id if dn.parent is not None else ""
            dc = (
                dn.parent.parent.id
                if dn.parent is not None and dn.parent.parent is not None
                else ""
            )
            rows.append(
                f"<tr><td>{_html.escape(dc)}</td><td>{_html.escape(rack)}</td>"
                f"<td><a href='http://{_html.escape(dn.public_url)}/ui/index.html'>"
                f"{_html.escape(dn.url)}</a></td>"
                f"<td>{len(dn.volumes)}</td><td>{dn.max_volume_count()}</td>"
                f"<td>{len(dn.ec_shards)}</td></tr>"
            )
        role = "leader" if self.is_leader else "follower"
        from seaweedfs_tpu_torch.util.status_ui import status_page

        return status_page(
            "SeaweedFS-TPU Master",
            f"Master {self.host}:{self.port}",
            f"role: <b>{role}</b> &middot; leader: {self.leader_address()}"
            f" &middot; max volume id: {self.topology.id_gen.peek()}",
            ["DataCenter", "Rack", "Node", "Volumes", "Max", "EC shards"],
            "".join(rows),
            ["/dir/status", "/cluster/status", "/metrics"],
        )

    # ------------------------------------------------------------------
    # leader vacuum loop (topology_vacuum.go:16-160 via
    # topology_event_handling.go StartRefreshWritableVolumes)
    def _vacuum_once(self, threshold: float | None = None) -> int:
        """One garbage-ratio sweep: replica-consistent check → compact
        all replicas → commit all (cleanup on failure). Returns the
        number of vacuumed volumes. `threshold` overrides the
        configured garbage ratio for this sweep (the /vol/vacuum
        ?garbageThreshold= path)."""
        if threshold is None:
            threshold = self.garbage_threshold
        # serialize sweeps: the 15-min loop and HTTP /vol/vacuum handler
        # threads must never overlap-compact the same volume (the second
        # compact would race the first commit's makeup-diff replay)
        with self._vacuum_sweep_lock:
            return self._vacuum_once_locked(threshold)

    def _vacuum_once_locked(self, threshold: float) -> int:
        compacted = 0
        for dn in self.topology.data_nodes():
            for vid, info in list(dn.volumes.items()):
                if info.read_only:
                    continue
                locations = self.topology.lookup(info.collection, vid) or [dn]
                try:
                    # phase 1: every replica must be above threshold
                    ratios = []
                    for node in locations:
                        with rpc.dial(self._node_grpc(node)) as ch:
                            resp = rpc.volume_stub(ch).VacuumVolumeCheck(
                                volume_pb2.VacuumVolumeCheckRequest(volume_id=vid),
                                timeout=30,
                            )
                        ratios.append(resp.garbage_ratio)
                    if not ratios or min(ratios) < threshold:
                        continue
                    # no write fence needed: each replica's compact
                    # snapshots without blocking writes and its commit
                    # replays the catch-up diff under the volume lock
                    # (volume_vacuum.go:78-133 Compact2 + makeupDiff)
                    for node in locations:
                        with rpc.dial(self._node_grpc(node)) as ch:
                            rpc.volume_stub(ch).VacuumVolumeCompact(
                                volume_pb2.VacuumVolumeCompactRequest(
                                    volume_id=vid
                                ),
                                timeout=600,
                            )
                    for node in locations:
                        with rpc.dial(self._node_grpc(node)) as ch:
                            rpc.volume_stub(ch).VacuumVolumeCommit(
                                volume_pb2.VacuumVolumeCommitRequest(
                                    volume_id=vid
                                ),
                                timeout=600,
                            )
                    compacted += 1
                except grpc.RpcError:
                    # phase 4: abandon scratch files on the replicas
                    for node in locations:
                        try:
                            with rpc.dial(self._node_grpc(node)) as ch:
                                rpc.volume_stub(ch).VacuumVolumeCleanup(
                                    volume_pb2.VacuumVolumeCleanupRequest(
                                        volume_id=vid
                                    ),
                                    timeout=30,
                                )
                        except grpc.RpcError:
                            pass
        return compacted

    def _vacuum_loop(self) -> None:
        while not self._stop_event.wait(self.vacuum_interval):
            if self.is_leader:
                try:
                    self._vacuum_once()
                except Exception:  # noqa: BLE001 - loop must survive
                    pass

    def _liveness_loop(self) -> None:
        """Sweep out data nodes whose beats stopped arriving without a
        stream teardown (the stream-break path at Heartbeat's finally
        covers clean deaths; this covers frozen/half-open ones)."""
        interval = max(1.0, self.node_timeout / 3)
        while not self._stop_event.wait(interval):
            if not self.is_leader:
                continue
            now = time.time()
            for dn in self.topology.data_nodes():
                with self._node_lock:
                    if dn.parent is None:  # a teardown beat us to it
                        continue
                    if not (
                        dn.last_seen and now - dn.last_seen > self.node_timeout
                    ):
                        continue
                    wlog.warning(
                        "master: node %s silent for %.0fs; unregistering",
                        dn.url,
                        now - dn.last_seen,
                    )
                    vids = list(dn.volumes)
                    self.topology.unregister_data_node(dn)
                    self.health.note_dead(dn.url)
                    if vids:
                        self._broadcast(dn.url, dn.public_url, [], vids)

    def start(self) -> None:
        self._grpc_pool = futures.ThreadPoolExecutor(max_workers=32)
        self._grpc_server = grpc.server(self._grpc_pool)
        self._grpc_server.add_generic_rpc_handlers(
            (rpc.servicer_handler(rpc.MASTER_SERVICE, rpc.MASTER_METHODS, self),)
        )
        if self._raft is not None:
            self._grpc_server.add_generic_rpc_handlers(
                (
                    rpc.servicer_handler(
                        rpc.RAFT_SERVICE, rpc.RAFT_METHODS, self._raft
                    ),
                )
            )
        rpc.add_port(self._grpc_server, f"{self.host}:{self.grpc_port}")
        self._grpc_server.start()
        if self._raft is not None:
            self._raft.start()

        self._http_server = WeedHTTPServer(
            (self.host, self.port), self._http_handler_class()
        )
        # tracing plane: assign/lookup hops get spans + request metrics
        self._http_server.trace_name = "master"
        self._http_server.trace_node = f"{self.host}:{self.port}"
        loops = [self._http_server.serve_forever]
        if self.vacuum_interval > 0:
            loops.append(self._vacuum_loop)
        if self.node_timeout > 0:
            loops.append(self._liveness_loop)
        for loop in loops:
            t = threading.Thread(target=loop, daemon=True)
            t.start()
            self._threads.append(t)
        # a serve loop that could not arm raises here, not later
        self._http_server.wait_armed()
        if self.repair is not None:
            self.repair.start()
        if self.telemetry is not None:
            self.telemetry.start()
        if self.tier is not None:
            self.tier.start()
        # continuous sampling profiler (telemetry/profiler.py): every
        # daemon serves /debug/profile; WEED_PROF=0 opts the process out
        from seaweedfs_tpu_torch.telemetry import profiler

        self._profiling = profiler.ensure_started()

    def stop(self) -> None:
        """Stop serving. Every thread start() made has ended when this
        returns: the HTTP listener, the vacuum and liveness loops, raft's
        ticker and replicators, the gRPC workers (grpc's own stop leaves
        its executor's threads alive) and this master's hold on the
        sampling profiler. A Heartbeat stream still open ends with the
        gRPC server, so its node is unregistered as on a stream break.
        The repair and tier schedulers' loops and the repairs and moves
        they launched have ended too, and so have the telemetry
        collector's loop and the capsule captures its alerts launched."""
        if self.tier is not None:
            self.tier.stop()
        if self.telemetry is not None:
            self.telemetry.stop()
        if self.repair is not None:
            self.repair.stop()
        self._stop_event.set()
        if self._raft is not None:
            self._raft.stop()
        if self._http_server:
            self._http_server.shutdown()
            self._http_server.server_close()
        for t in self._threads:
            t.join(timeout=10)
        self._threads.clear()
        if self._grpc_server:
            rpc.stop_server(self._grpc_server, self._grpc_pool)
        if self._profiling:
            from seaweedfs_tpu_torch.telemetry import profiler

            profiler.release()
            self._profiling = False
