"""Server subcommands: master, volume, filer, s3, webdav, server
(all-in-one), shell — the daemon half of the reference CLI
(weed/command/master.go, volume.go, filer.go, s3.go, webdav.go,
server.go:30-100, shell.go); the port of
seaweedfs_tpu/command/servers.py.

`master`, `volume`, `server` (master + volume server in one process)
and `shell` run on the port's servers, whose EC paths run on the card
unless `-ec.codec` names a host codec. What needs a plane the port does
not have yet exits 2 naming its ROADMAP item: `filer`, `s3`, `webdav`
and `mount`, and `server`'s -filer/-s3/-webdav (item 11); the
`volume.worker` processes of `-workers N` (item 8); the telemetry
collector, `-telemetryInterval` > 0 (item 13, so a master started from
the command line passes -telemetryInterval 0); and the disk-fault shim
that WEED_CHAOS_DISK arms (item 14)."""

from __future__ import annotations

import argparse
import signal
import threading

from seaweedfs_tpu_torch.command import Command, Waiting, register
from seaweedfs_tpu_torch.util import wlog


def _tune_gc() -> None:
    """Daemon-mode GC posture: freeze boot-time objects out of the young
    generation and raise the gen-0 threshold so the cyclic collector
    stops running every ~700 allocations mid-request (the request path
    allocates acyclically; measured ~5% of data-plane CPU). Collections
    still happen, just far less often — this is tuning, not disabling."""
    import gc

    gc.collect()
    gc.freeze()
    gc.set_threshold(100_000, 1_000, 1_000)


def _wait_forever() -> int:
    stop = threading.Event()

    def on_signal(signum, frame):
        stop.set()

    signal.signal(signal.SIGINT, on_signal)
    signal.signal(signal.SIGTERM, on_signal)
    _tune_gc()
    stop.wait()
    return 0


def _wait_with_drain() -> tuple[int, bool]:
    """Volume-daemon wait (docs/HEALTH.md drain runbook): SIGTERM asks
    for a GRACEFUL drain — announce draining, shed new writes, finish
    in-flight requests, deregister — while SIGINT keeps the abrupt
    exit. Returns (rc, drain_requested)."""
    stop = threading.Event()
    drain = threading.Event()

    def on_term(signum, frame):
        drain.set()
        stop.set()

    def on_int(signum, frame):
        stop.set()

    signal.signal(signal.SIGINT, on_int)
    signal.signal(signal.SIGTERM, on_term)
    _tune_gc()
    stop.wait()
    return 0, drain.is_set()


def _configure_tls(component: str) -> None:
    """security.toml [grpc]/[grpc.<component>] → process-wide gRPC TLS
    (security/tls.go LoadServerTLS/LoadClientTLS role)."""
    from seaweedfs_tpu_torch.pb import rpc
    from seaweedfs_tpu_torch.security.tls import load_tls_config
    from seaweedfs_tpu_torch.util.config import load_config

    cfg = load_config("security")
    tls = load_tls_config(cfg, component)
    if tls is not None:
        rpc.set_tls(tls, cfg.get_string("grpc.server_name"))


def _add_trace_flags(p: argparse.ArgumentParser) -> None:
    """Tracing-plane knobs shared by every daemon command
    (docs/TRACING.md): -traceSlowMs writes completed slow traces
    through wlog with the request ID (0 = off); -traceSample N
    head-samples 1-in-N headerless roots (1 = trace everything)."""
    p.add_argument(
        "-traceSlowMs",
        type=float,
        default=None,
        help="log completed root spans slower than this many ms "
        "through wlog with their trace ID (an explicit 0 disables; "
        "unset keeps the WEED_TRACE_SLOW_MS env or 0)",
    )
    p.add_argument(
        "-traceSample",
        type=int,
        default=0,
        help="head-sample 1 in N requests without an inbound trace "
        "header (1 traces every request; 0/default keeps the "
        "WEED_TRACE_SAMPLE env or 1)",
    )


def _add_serve_flags(p: argparse.ArgumentParser) -> None:
    """Serving-core knobs shared by the data-plane daemons
    (docs/SERVING.md), enforced identically by the C epoll loop and
    the threaded mini loop."""
    p.add_argument(
        "-serveIdleMs",
        type=int,
        default=30000,
        help="close keep-alive connections idle longer than this many "
        "milliseconds (0 = never; bounds fd usage under millions of "
        "mostly-idle clients)",
    )
    p.add_argument(
        "-serveMaxReqs",
        type=int,
        default=0,
        help="serve at most N requests per connection, then close with "
        "Connection: close (0 = unlimited; rebalances long-lived "
        "clients across SO_REUSEPORT accept processes)",
    )


def _add_admission_flags(p: argparse.ArgumentParser) -> None:
    """QoS admission-control knobs shared by the serving daemons
    (docs/QOS.md): token bucket per client key + process-wide in-flight
    cap, shedding with 503 + Retry-After instead of collapsing."""
    p.add_argument(
        "-admissionRate",
        type=float,
        default=0.0,
        help="per-client admitted requests/second (token bucket keyed "
        "by S3 access key or remote address; 0 = admission off). With "
        "-serveProcs N each sibling enforces rate/N of the budget",
    )
    p.add_argument(
        "-admissionBurst",
        type=float,
        default=0.0,
        help="per-client token-bucket burst capacity (0 = 2x the rate)",
    )
    p.add_argument(
        "-admissionInflight",
        type=int,
        default=0,
        help="shed with 503 once this many requests are in flight in "
        "this process, regardless of client (queue-length cap; 0 = "
        "uncapped)",
    )
    p.add_argument(
        "-admissionProcs",
        type=int,
        default=0,
        help="process-group size the per-client admission budget is "
        "divided by (0 = the -serveProcs value; set automatically on "
        "spawned siblings, which re-run with -serveProcs 1 and would "
        "otherwise each enforce the FULL budget)",
    )
    p.add_argument(
        "-admissionShmPath",
        default="",
        help="mmap'd token-bucket file ALL the port's accept processes "
        "charge (docs/QOS.md): the GLOBAL per-client rate holds under "
        "any connection spread, and the C serving loop sheds natively. "
        "Auto-created under $TMPDIR when -admissionRate is set with "
        "-serveProcs/-workers > 1; empty with a single process = the "
        "in-process bucket",
    )


def _apply_trace_flags(args) -> None:
    from seaweedfs_tpu_torch import trace

    slow_ms = getattr(args, "traceSlowMs", None)
    if slow_ms is not None:  # unset keeps the WEED_TRACE_SLOW_MS env
        trace.set_slow_threshold_ms(slow_ms)
    if getattr(args, "traceSample", 0) > 0:
        trace.set_sample_every(args.traceSample)
    # weedchaos (docs/CHAOS.md): every daemon command funnels through
    # here before serving; a WEED_CHAOS_DISK spec in the environment
    # would arm the disk-fault shim, which the port does not have
    import os

    if os.environ.get("WEED_CHAOS_DISK", ""):
        raise NotImplementedError(
            "WEED_CHAOS_DISK needs analysis/chaos, not ported yet "
            "(ROADMAP item 14)"
        )


def _load_guard():
    """security.toml → Guard (None when not configured)."""
    from seaweedfs_tpu_torch.security import Guard
    from seaweedfs_tpu_torch.util.config import load_config

    cfg = load_config("security")
    key = cfg.get_string("jwt.signing.key")
    read_key = cfg.get_string("jwt.signing.read.key")
    white = cfg.get("access.white_list") or []
    if isinstance(white, str):
        white = [w for w in white.split(",") if w]
    if not key and not read_key and not white:
        return None
    return Guard(
        white_list=white,
        signing_key=key,
        expires_after_sec=cfg.get_int("jwt.signing.expires_after_seconds", 10),
        read_signing_key=read_key,
        read_expires_after_sec=cfg.get_int(
            "jwt.signing.read.expires_after_seconds", 60
        ),
    )


@register
class MasterCommand(Command):
    name = "master"
    help = "start the cluster master (volume assignment, topology, lookup)"

    def add_arguments(self, p: argparse.ArgumentParser) -> None:
        p.add_argument("-ip", default="127.0.0.1", help="bind address")
        p.add_argument("-port", type=int, default=9333, help="listen port")
        p.add_argument(
            "-volumeSizeLimitMB", type=int, default=30 * 1024,
            help="roll to a fresh volume past this size",
        )
        p.add_argument(
            "-defaultReplication", default="000",
            help="replication policy for new volumes like 001",
        )
        p.add_argument(
            "-garbageThreshold", type=float, default=0.3,
            help="deleted-bytes fraction that triggers vacuum",
        )
        p.add_argument(
            "-peers",
            default="",
            help="comma-separated master peers incl. self (HA raft cluster)",
        )
        p.add_argument("-mdir", default="", help="raft/meta data directory")
        p.add_argument(
            "-nodeTimeout",
            type=float,
            default=30.0,
            help="seconds of heartbeat silence before a volume server is "
            "declared dead even if its stream stays open (0 disables)",
        )
        p.add_argument(
            "-repairInterval",
            type=float,
            default=30.0,
            help="seconds between automatic-repair scans (scrub plane: "
            "rebuild missing EC shards, fix under-replication, replace "
            "scrub-flagged corrupt replicas; 0 disables — repair goes "
            "back to manual ec.rebuild / volume.fix.replication)",
        )
        p.add_argument(
            "-repairConcurrency",
            type=int,
            default=2,
            help="global cap on simultaneously running repairs",
        )
        p.add_argument(
            "-repairGrace",
            type=float,
            default=30.0,
            help="seconds damage must persist before repair starts "
            "(rides out shard moves and node restarts)",
        )
        p.add_argument(
            "-telemetryInterval",
            type=float,
            default=10.0,
            help="seconds between leader-side cluster telemetry scrapes "
            "(/metrics from every node into the ring TSDB feeding "
            "/cluster/health, /cluster/alerts, /cluster/top; 0 disables)",
        )
        p.add_argument(
            "-tierInterval",
            type=float,
            default=0.0,
            help="seconds between lifecycle-tiering scans "
            "(docs/TIERING.md): age/temperature rules move cold EC "
            "volumes to the WEED_TIER_BACKEND object store and recall "
            "hot ones; 0 disables — tiering stays manual (tier.move)",
        )
        p.add_argument(
            "-assignPolicy",
            default="p2c",
            choices=("p2c", "random"),
            help="pick-for-write policy (docs/QOS.md): p2c = "
            "power-of-two-choices weighted by the nodes' heartbeat-"
            "reported in-flight/write-queue depth; random = the classic "
            "pure-random pick (also what WEED_QOS=0 forces)",
        )
        p.add_argument("-cpuprofile", default="", help="dump pstats profile here on exit")
        p.add_argument(
            "-sequencer.etcd",
            dest="sequencer_etcd",
            default="",
            help="etcd endpoint(s) for the external-KV sequencer "
            "(sequence/etcd_sequencer.go role); default: file/memory",
        )
        _add_trace_flags(p)
        p.add_argument("-v", type=int, default=0, help="verbosity")

    def run(self, args) -> int:
        from seaweedfs_tpu_torch.server.master_server import MasterServer

        wlog.set_verbosity(args.v)
        _apply_trace_flags(args)
        if args.peers and not args.mdir:
            print("master: -peers requires -mdir (persistent raft state)")
            return 2
        _configure_tls("master")
        sequencer = None
        if args.sequencer_etcd:
            from seaweedfs_tpu_torch.sequence import EtcdSequencer

            sequencer = EtcdSequencer(args.sequencer_etcd)
        server = MasterServer(
            host=args.ip,
            port=args.port,
            volume_size_limit_mb=args.volumeSizeLimitMB,
            default_replication=args.defaultReplication,
            garbage_threshold=args.garbageThreshold,
            guard=_load_guard(),
            peers=args.peers or None,
            raft_dir=args.mdir or None,
            node_timeout=args.nodeTimeout,
            sequencer=sequencer,
            repair_interval=args.repairInterval,
            repair_concurrency=args.repairConcurrency,
            repair_grace=args.repairGrace,
            telemetry_interval=args.telemetryInterval,
            tier_interval=args.tierInterval,
            assign_policy=args.assignPolicy,
        )
        from seaweedfs_tpu_torch.util.profiling import CpuProfile

        # the profiler must wrap start(): threads created before
        # enable() (gRPC executor, raft loops) are never instrumented
        with CpuProfile(args.cpuprofile):
            server.start()
            wlog.info(
                "master listening on %s:%d (grpc %d)",
                args.ip,
                args.port,
                args.port + 10000,
            )
            try:
                return _wait_forever()
            finally:
                server.stop()


@register
class VolumeCommand(Command):
    name = "volume"
    help = "start a volume server (blob data plane)"

    def add_arguments(self, p: argparse.ArgumentParser) -> None:
        p.add_argument("-ip", default="127.0.0.1", help="bind address")
        p.add_argument("-port", type=int, default=8080, help="listen port")
        p.add_argument("-dir", default=".", help="comma-separated data directories")
        p.add_argument("-max", default="7", help="comma-separated max volume counts")
        p.add_argument(
            "-mserver", default="127.0.0.1:9333",
            help="comma-separated master address(es)",
        )
        p.add_argument("-dataCenter", default="", help="topology data center name")
        p.add_argument("-rack", default="", help="topology rack name")
        p.add_argument(
            "-publicUrl", default="",
            help="address advertised to clients (default ip:port)",
        )
        p.add_argument(
            "-announce", default="",
            help="host:port advertised to the CLUSTER (heartbeat "
            "ip/port peers and repair verbs dial) when this server is "
            "reached through a proxy/NAT hop; default ip:port",
        )
        p.add_argument(
            "-heartbeat", type=float, default=2.0,
            help="seconds between master heartbeats; the master's "
            "phi-accrual gray-failure detector (docs/HEALTH.md) learns "
            "this cadence, so lower = faster suspect detection",
        )
        p.add_argument(
            "-readRedirect", action="store_true",
            help="302-redirect reads for volumes this server lacks",
        )
        p.add_argument("-cpuprofile", default="", help="dump pstats profile here on exit")
        p.add_argument(
            "-index",
            default="memory",
            choices=("memory", "db"),
            help="needle map kind: memory (CompactMap) | db (persistent sqlite)",
        )
        p.add_argument(
            "-ec.codec",
            dest="ec_codec",
            default="",
            choices=("", "cpu", "native", "cuda"),
            help="EC codec backend; empty = cuda on the card (a host "
            "codec runs only when named here or by WEED_EC_CODEC)",
        )
        p.add_argument(
            "-workers",
            type=int,
            default=1,
            help="data-plane processes sharing this port via SO_REUSEPORT "
            "(1 = classic single process; N>1 adds N-1 read workers so "
            "multi-core hosts scale the GIL-bound read path — see "
            "server/volume_workers.py)",
        )
        p.add_argument(
            "-shardWrites",
            action="store_true",
            help="with -workers N: partition WRITE ownership across the "
            "N processes by volume id (vid %% N), each appending its own "
            "volumes' .dat/.idx — multi-core write scaling under the "
            "single-writer-per-volume invariant; admin ops (vacuum, EC "
            "encode, readonly) hand ownership back to the lead first",
        )
        p.add_argument(
            "-scrubInterval",
            type=float,
            default=600.0,
            help="seconds between background integrity sweeps (needle "
            "CRC re-checks + EC parity re-verify; 0 disables)",
        )
        p.add_argument(
            "-scrubRate",
            type=float,
            default=64.0,
            help="scrub bandwidth cap in MB/s (token bucket protecting "
            "foreground read p99; <=0 = unlimited)",
        )
        p.add_argument(
            "-commitWindowUs",
            type=int,
            default=0,
            help="group-commit window in microseconds (docs/QOS.md): "
            "concurrent POSTs against one volume coalesce into one "
            "pwritev + one flush per window; 0 = off (write-per-POST)",
        )
        p.add_argument(
            "-commitBytes",
            type=int,
            default=4 << 20,
            help="group-commit byte cap: a window commits early once "
            "its batched bodies reach this many bytes",
        )
        p.add_argument(
            "-commitBatch",
            type=int,
            default=64,
            help="group-commit batch cap: a window commits early once "
            "this many writes have joined it",
        )
        p.add_argument(
            "-commitFsync",
            action="store_true",
            help="fsync the .dat on every commit point (per POST "
            "without -commitWindowUs, per window with it) — the "
            "durability lever the fsyncs-per-POST bench ratio measures",
        )
        _add_admission_flags(p)
        _add_serve_flags(p)
        _add_trace_flags(p)
        p.add_argument(
            "-v", type=int, default=0,
            help="log verbosity (0=warning .. 3=trace)",
        )

    def run(self, args) -> int:
        from seaweedfs_tpu_torch.server.volume_server import VolumeServer
        from seaweedfs_tpu_torch.util.config import load_config

        wlog.set_verbosity(args.v)
        _apply_trace_flags(args)
        dirs = args.dir.split(",")
        maxes = [int(m) for m in args.max.split(",")]
        if len(maxes) == 1:
            maxes = maxes * len(dirs)
        if args.workers > 1:
            raise NotImplementedError(
                "-workers > 1 needs server/volume_workers.py, not ported "
                "yet (ROADMAP item 8)"
            )
        _configure_tls("volume")
        server = VolumeServer(
            dirs,
            host=args.ip,
            port=args.port,
            master=args.mserver,
            public_url=args.publicUrl,
            data_center=args.dataCenter,
            rack=args.rack,
            max_volume_counts=maxes,
            heartbeat_interval=args.heartbeat,
            read_redirect=args.readRedirect,
            guard=_load_guard(),
            ec_codec=args.ec_codec,
            storage_backends=load_config("master").sub("storage.backend"),
            needle_map_kind=args.index,
            scrub_interval=args.scrubInterval,
            scrub_rate_mb_s=args.scrubRate,
            serve_idle_ms=args.serveIdleMs,
            serve_max_reqs=args.serveMaxReqs,
            commit_window_us=args.commitWindowUs,
            commit_bytes=args.commitBytes,
            commit_batch=args.commitBatch,
            commit_fsync=args.commitFsync,
            admission_rate=args.admissionRate,
            admission_burst=args.admissionBurst,
            admission_inflight=args.admissionInflight,
            admission_procs=args.admissionProcs or 1,
            admission_shm_path=args.admissionShmPath,
            announce=args.announce,
        )
        from seaweedfs_tpu_torch.util.profiling import CpuProfile

        with CpuProfile(args.cpuprofile):
            server.start()
            wlog.info(
                "volume server %s:%d -> master %s",
                args.ip, args.port, args.mserver,
            )
            drained = False
            try:
                rc, drained = _wait_with_drain()
                return rc
            finally:
                if drained:
                    # SIGTERM = graceful drain (docs/HEALTH.md): stop
                    # taking assignments, finish in-flight, deregister
                    server.drain()
                else:
                    server.stop()


@register
class VolumeWorkerCommand(Waiting):
    name = "volume.worker"
    help = "internal: one SO_REUSEPORT read worker (spawned by volume -workers N)"
    item = 8

    def add_arguments(self, p: argparse.ArgumentParser) -> None:
        p.add_argument("-ip", default="127.0.0.1", help="bind address")
        p.add_argument("-port", type=int, required=True, help="listen port")
        p.add_argument(
            "-dir", required=True,
            help="data directory (shared with the lead)",
        )
        p.add_argument("-lead", required=True, help="lead's internal host:port")
        p.add_argument(
            "-workerPort", type=int, default=0,
            help="internal lead port for worker coordination",
        )
        p.add_argument(
            "-shardWrites", action="store_true",
            help="enable per-volume write sharding across workers",
        )
        p.add_argument(
            "-writerIndex", type=int, default=0,
            help="this worker's writer slot (0..writers-1)",
        )
        p.add_argument(
            "-writers", type=int, default=1,
            help="total writer slots in the shard-write group",
        )
        p.add_argument(
            "-mserver", default="",
            help="comma-separated master address(es)",
        )
        p.add_argument(
            "-internalPort", type=int, default=0,
            help="loopback listener port for trusted worker hops",
        )
        p.add_argument(
            "-commitWindowUs", type=int, default=0,
            help="group-commit window (µs) for vids this worker owns "
            "under -shardWrites; 0 = write-per-POST (docs/QOS.md)",
        )
        p.add_argument(
            "-commitBytes", type=int, default=4 << 20,
            help="group-commit byte cap (commit early past this)",
        )
        p.add_argument(
            "-commitBatch", type=int, default=64,
            help="group-commit batch cap (commit early past this)",
        )
        p.add_argument(
            "-commitFsync", action="store_true",
            help="fsync the .dat at every owned-write commit point",
        )
        _add_admission_flags(p)
        _add_trace_flags(p)
        p.add_argument(
            "-v", type=int, default=0,
            help="log verbosity (0=warning .. 3=trace)",
        )


@register
class FilerCommand(Waiting):
    name = "filer"
    help = "start a filer (directory/file namespace over the blob store)"
    item = 11

    def add_arguments(self, p: argparse.ArgumentParser) -> None:
        p.add_argument("-ip", default="127.0.0.1", help="bind address")
        p.add_argument("-port", type=int, default=8888, help="listen port")
        p.add_argument(
            "-master", default="127.0.0.1:9333",
            help="master address host:port",
        )
        p.add_argument(
            "-store", default="memory", help="memory | sqlite | sql | sortedlog | lsm | redis | cassandra | etcd | tikv | mysql | postgres"
        )
        p.add_argument(
            "-storePath", default="",
            help="store path/DSN (sqlite file, redis host, ...)",
        )
        p.add_argument(
            "-collection", default="",
            help="collection for filer-written chunks",
        )
        p.add_argument(
            "-replication", default="",
            help="replication policy for filer-written chunks",
        )
        p.add_argument(
            "-maxMB", type=int, default=32,
            help="split uploads into chunks of this many MB",
        )
        _add_trace_flags(p)
        p.add_argument(
            "-v", type=int, default=0,
            help="log verbosity (0=warning .. 3=trace)",
        )


@register
class S3Command(Waiting):
    name = "s3"
    help = "start the S3-compatible gateway over a filer"
    item = 11

    def add_arguments(self, p: argparse.ArgumentParser) -> None:
        p.add_argument("-ip", default="127.0.0.1", help="bind address")
        p.add_argument("-port", type=int, default=8333, help="listen port")
        p.add_argument(
            "-filer", default="127.0.0.1:8888",
            help="filer address host:port backing the gateway",
        )
        p.add_argument(
            "-bucketsPath", default="/buckets",
            help="filer directory that holds the buckets",
        )
        p.add_argument("-config", default="", help="identities toml with access/secret keys")
        p.add_argument(
            "-master",
            default="",
            help="comma-separated master(s) to announce this gateway to "
            "(telemetry plane; empty = not scraped by the collector)",
        )
        p.add_argument(
            "-serveProcs",
            type=int,
            default=1,
            help="accept processes sharing this port via SO_REUSEPORT "
            "(N>1 spawns N-1 sibling gateways; the kernel spreads "
            "connections across them — docs/SERVING.md)",
        )
        p.add_argument(
            "-reusePort",
            action="store_true",
            help="bind with SO_REUSEPORT (set automatically on the "
            "siblings -serveProcs spawns; set by hand to run your own "
            "process group behind one port)",
        )
        _add_admission_flags(p)
        _add_serve_flags(p)
        _add_trace_flags(p)
        p.add_argument(
            "-v", type=int, default=0,
            help="log verbosity (0=warning .. 3=trace)",
        )


@register
class WebDavCommand(Waiting):
    name = "webdav"
    help = "start the WebDAV gateway over a filer"
    item = 11

    def add_arguments(self, p: argparse.ArgumentParser) -> None:
        p.add_argument("-ip", default="127.0.0.1", help="bind address")
        p.add_argument("-port", type=int, default=7333, help="listen port")
        p.add_argument(
            "-filer", default="127.0.0.1:8888",
            help="filer address host:port backing the gateway",
        )
        p.add_argument(
            "-master",
            default="",
            help="comma-separated master(s) to announce this gateway to "
            "(telemetry plane; empty = not scraped by the collector)",
        )
        p.add_argument(
            "-serveProcs",
            type=int,
            default=1,
            help="accept processes sharing this port via SO_REUSEPORT "
            "(N>1 spawns N-1 sibling gateways; the kernel spreads "
            "connections across them — docs/SERVING.md)",
        )
        p.add_argument(
            "-reusePort",
            action="store_true",
            help="bind with SO_REUSEPORT (set automatically on the "
            "siblings -serveProcs spawns; set by hand to run your own "
            "process group behind one port)",
        )
        _add_admission_flags(p)
        _add_serve_flags(p)
        _add_trace_flags(p)
        p.add_argument(
            "-v", type=int, default=0,
            help="log verbosity (0=warning .. 3=trace)",
        )


@register
class ServerCommand(Command):
    name = "server"
    help = "start master + volume server(s) [+ filer + s3] in one process"

    def add_arguments(self, p: argparse.ArgumentParser) -> None:
        p.add_argument(
            "-ip", default="127.0.0.1",
            help="bind address for every embedded daemon",
        )
        p.add_argument(
            "-master.port", dest="master_port", type=int, default=9333,
            help="master listen port",
        )
        p.add_argument(
            "-volume.port", dest="volume_port", type=int, default=8080,
            help="volume-server listen port",
        )
        p.add_argument(
            "-dir", default=".",
            help="data directory for volume + master meta",
        )
        p.add_argument(
            "-master.volumeSizeLimitMB", dest="vsl", type=int, default=30 * 1024,
            help="roll to a fresh volume past this size",
        )
        p.add_argument(
            "-master.defaultReplication", dest="repl", default="000",
            help="replication policy for new volumes like 001",
        )
        p.add_argument(
            "-volume.max", dest="vmax", default="7",
            help="comma-separated max volume counts",
        )
        p.add_argument("-dataCenter", default="", help="topology data center name")
        p.add_argument("-rack", default="", help="topology rack name")
        p.add_argument("-filer", action="store_true", help="also start a filer")
        p.add_argument(
            "-filer.port", dest="filer_port", type=int, default=8888,
            help="filer listen port",
        )
        p.add_argument(
            "-filer.store", dest="filer_store", default="memory",
            help="filer metadata store kind",
        )
        p.add_argument("-s3", action="store_true", help="also start an S3 gateway")
        p.add_argument(
            "-s3.port", dest="s3_port", type=int, default=8333,
            help="S3 gateway listen port",
        )
        p.add_argument(
            "-webdav", action="store_true",
            help="also start a WebDAV gateway",
        )
        p.add_argument(
            "-webdav.port", dest="webdav_port", type=int, default=7333,
            help="WebDAV gateway listen port",
        )
        p.add_argument(
            "-ec.codec",
            dest="ec_codec",
            default="",
            choices=("", "cpu", "native", "cuda"),
            help="EC codec backend; empty = cuda on the card (a host "
            "codec runs only when named here or by WEED_EC_CODEC)",
        )
        # scrub/self-healing knobs, same semantics as the standalone
        # master/volume commands (0 disables either plane)
        p.add_argument(
            "-repairInterval", type=float, default=30.0,
            help="seconds between repair-scheduler scans (0 disables)",
        )
        p.add_argument(
            "-repairConcurrency", type=int, default=2,
            help="max repairs in flight",
        )
        p.add_argument(
            "-repairGrace", type=float, default=30.0,
            help="seconds of damage persistence before repairing",
        )
        p.add_argument(
            "-scrubInterval", type=float, default=600.0,
            help="seconds between scrub sweeps (0 disables)",
        )
        p.add_argument(
            "-scrubRate", type=float, default=64.0,
            help="scrub bandwidth cap in MB/s",
        )
        p.add_argument(
            "-telemetryInterval", type=float, default=10.0,
            help="seconds between collector scrape cycles (0 disables)",
        )
        p.add_argument(
            "-tierInterval", type=float, default=0.0,
            help="seconds between lifecycle-tiering scans (0 disables; "
            "docs/TIERING.md)",
        )
        _add_trace_flags(p)
        p.add_argument(
            "-v", type=int, default=0,
            help="log verbosity (0=warning .. 3=trace)",
        )

    def run(self, args) -> int:
        if args.filer or args.s3 or args.webdav:
            raise NotImplementedError(
                "server -filer/-s3/-webdav need the filer and its "
                "gateways, not ported yet (ROADMAP item 11)"
            )
        _configure_tls("master")
        from seaweedfs_tpu_torch.server.master_server import MasterServer
        from seaweedfs_tpu_torch.server.volume_server import VolumeServer

        wlog.set_verbosity(args.v)
        _apply_trace_flags(args)
        guard = _load_guard()
        started = []
        try:
            master = MasterServer(
                host=args.ip,
                port=args.master_port,
                volume_size_limit_mb=args.vsl,
                default_replication=args.repl,
                guard=guard,
                # the all-in-one server gets the full self-healing plane
                # by default, like the standalone `weed master`
                repair_interval=args.repairInterval,
                repair_concurrency=args.repairConcurrency,
                repair_grace=args.repairGrace,
                telemetry_interval=args.telemetryInterval,
                tier_interval=args.tierInterval,
            )
            master.start()
            started.append(master)
            dirs = args.dir.split(",")
            maxes = [int(m) for m in args.vmax.split(",")]
            if len(maxes) == 1:
                maxes = maxes * len(dirs)
            volume = VolumeServer(
                dirs,
                host=args.ip,
                port=args.volume_port,
                master=f"{args.ip}:{args.master_port}",
                data_center=args.dataCenter,
                rack=args.rack,
                max_volume_counts=maxes,
                guard=guard,
                ec_codec=args.ec_codec,
                scrub_interval=args.scrubInterval,
                scrub_rate_mb_s=args.scrubRate,
            )
            volume.start()
            started.append(volume)
            wlog.info("all-in-one server up: %d components", len(started))
            return _wait_forever()
        finally:
            # also when a component failed to come up: the ones already
            # started must not outlive the command
            for s in reversed(started):
                s.stop()


@register
class ShellCommand(Command):
    name = "shell"
    help = "interactive admin shell (ec.*, volume.*, fs.* commands)"

    def add_arguments(self, p: argparse.ArgumentParser) -> None:
        p.add_argument(
            "-master", default="127.0.0.1:9333",
            help="comma-separated master address(es)",
        )
        p.add_argument("-c", dest="script", default="", help="run semicolon-separated commands and exit")

    def run(self, args) -> int:
        import io
        import sys

        from seaweedfs_tpu_torch.shell.shell_runner import run_shell

        _configure_tls("client")
        masters = args.master.split(",")
        if args.script:
            fake_stdin = io.StringIO(
                "\n".join(s.strip() for s in args.script.split(";")) + "\nexit\n"
            )
            run_shell(masters, stdin=fake_stdin, stdout=sys.stdout)
            return 0
        run_shell(masters)
        return 0


@register
class MountCommand(Waiting):
    name = "mount"
    help = "mount the filer as a FUSE filesystem (command/mount_std.go)"
    item = 11

    def add_arguments(self, p: argparse.ArgumentParser) -> None:
        p.add_argument(
            "-filer", default="127.0.0.1:8888",
            help="filer address host:port to mount",
        )
        p.add_argument(
            "-dir", required=False, default="",
            help="local mountpoint directory",
        )
        p.add_argument(
            "-filer.path", dest="filer_path", default="/",
            help="filer subtree to mount as the root",
        )

