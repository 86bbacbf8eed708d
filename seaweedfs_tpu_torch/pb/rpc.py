"""gRPC service binding without grpc_tools.

Each service is a method table {name: (RequestCls, ResponseCls, kind)};
`servicer_handler` turns an implementation object into a generic
handler for grpc.Server, and `Stub` builds the client-side callables on
a channel. Equivalent to what generated *_pb2_grpc code does, minus the
codegen dependency.
"""

from __future__ import annotations

import threading

import grpc

from seaweedfs_tpu_torch.pb import filer_pb2 as f
from seaweedfs_tpu_torch.pb import master_pb2 as m
from seaweedfs_tpu_torch.pb import raft_pb2 as r
from seaweedfs_tpu_torch.pb import volume_pb2 as v
from seaweedfs_tpu_torch.util import deadline as _deadline

GRPC_PORT_OFFSET = 10000  # reference convention: grpc port = http port + 10000


def grpc_address(http_addr: str) -> str:
    """"host:9333" → "host:19333"."""
    host, _, port = http_addr.partition(":")
    return f"{host}:{int(port) + GRPC_PORT_OFFSET}"


# --- process-wide gRPC TLS (security/tls.go role) ---------------------------
# set_tls() installs one TlsConfig for every dial()/add_port() in the
# process; None (default) keeps plaintext channels. The grpc "target
# name override" lets certs issued for a common name (e.g. "seaweedfs")
# verify against 127.0.0.1 endpoints, as cluster-internal mTLS needs.
_TLS = None
_TLS_SERVER_NAME = ""


def set_tls(tls, server_name_override: str = "") -> None:
    global _TLS, _TLS_SERVER_NAME
    _TLS = tls
    _TLS_SERVER_NAME = server_name_override
    _reset_channel_cache()  # pooled channels carry the old credentials


_CHANNEL_CACHE: dict[str, grpc.Channel] = {}
_CHANNEL_CACHE_LOCK = threading.Lock()


def cached_channel(addr: str) -> grpc.Channel:
    """Process-wide pooled channel to `addr` (grpc channels are
    thread-safe and multiplex concurrent RPCs over one HTTP/2
    connection). The reference pools the same way
    (operation/grpc_client.go:15-41); dialing per call pays a fresh
    TCP+HTTP/2 handshake on every assign/lookup. Never close the
    returned channel — set_tls() invalidates the pool wholesale."""
    with _CHANNEL_CACHE_LOCK:
        ch = _CHANNEL_CACHE.get(addr)
        if ch is None:
            ch = _CHANNEL_CACHE[addr] = dial(addr)
        return ch


def _reset_channel_cache() -> None:
    with _CHANNEL_CACHE_LOCK:
        old = list(_CHANNEL_CACHE.values())
        _CHANNEL_CACHE.clear()
    for ch in old:
        try:
            ch.close()
        except Exception:
            pass


def dial(addr: str) -> grpc.Channel:
    """TLS channel when the process has TLS configured, else plaintext
    (the single seam every client-side channel goes through)."""
    if _TLS is not None and _TLS.is_enabled:
        from seaweedfs_tpu_torch.security.tls import client_credentials

        options = []
        if _TLS_SERVER_NAME:
            options.append(
                ("grpc.ssl_target_name_override", _TLS_SERVER_NAME)
            )
        return grpc.secure_channel(addr, client_credentials(_TLS), options)
    return grpc.insecure_channel(addr)


def add_port(server: grpc.Server, addr: str) -> None:
    """Bind a server port honoring the process TLS config."""
    if _TLS is not None and _TLS.is_enabled:
        from seaweedfs_tpu_torch.security.tls import server_credentials

        server.add_secure_port(addr, server_credentials(_TLS))
    else:
        server.add_insecure_port(addr)


UNARY_UNARY = "unary_unary"
UNARY_STREAM = "unary_stream"
STREAM_UNARY = "stream_unary"
STREAM_STREAM = "stream_stream"

MASTER_SERVICE = "seaweedfs_tpu.master.Master"
MASTER_METHODS = {
    "Heartbeat": (m.HeartbeatRequest, m.HeartbeatResponse, STREAM_STREAM),
    "KeepConnected": (m.ClientHello, m.VolumeLocationDelta, STREAM_STREAM),
    "Assign": (m.AssignRequest, m.AssignResponse, UNARY_UNARY),
    "LookupVolume": (m.LookupVolumeRequest, m.LookupVolumeResponse, UNARY_UNARY),
    "LookupEcVolume": (m.LookupEcVolumeRequest, m.LookupEcVolumeResponse, UNARY_UNARY),
    "Statistics": (m.StatisticsRequest, m.StatisticsResponse, UNARY_UNARY),
    "CollectionList": (m.CollectionListRequest, m.CollectionListResponse, UNARY_UNARY),
    "CollectionDelete": (m.CollectionDeleteRequest, m.CollectionDeleteResponse, UNARY_UNARY),
    "VolumeList": (m.VolumeListRequest, m.VolumeListResponse, UNARY_UNARY),
    "GetMasterConfiguration": (
        m.GetMasterConfigurationRequest,
        m.GetMasterConfigurationResponse,
        UNARY_UNARY,
    ),
}

VOLUME_SERVICE = "seaweedfs_tpu.volume.VolumeServer"
VOLUME_METHODS = {
    "BatchDelete": (v.BatchDeleteRequest, v.BatchDeleteResponse, UNARY_UNARY),
    "VacuumVolumeCheck": (v.VacuumVolumeCheckRequest, v.VacuumVolumeCheckResponse, UNARY_UNARY),
    "VacuumVolumeCompact": (v.VacuumVolumeCompactRequest, v.VacuumVolumeCompactResponse, UNARY_UNARY),
    "VacuumVolumeCommit": (v.VacuumVolumeCommitRequest, v.VacuumVolumeCommitResponse, UNARY_UNARY),
    "VacuumVolumeCleanup": (v.VacuumVolumeCleanupRequest, v.VacuumVolumeCleanupResponse, UNARY_UNARY),
    "AllocateVolume": (v.AllocateVolumeRequest, v.AllocateVolumeResponse, UNARY_UNARY),
    "DeleteCollection": (v.DeleteCollectionRequest, v.DeleteCollectionResponse, UNARY_UNARY),
    "VolumeDelete": (v.VolumeDeleteRequest, v.VolumeDeleteResponse, UNARY_UNARY),
    "VolumeMarkReadonly": (v.VolumeMarkReadonlyRequest, v.VolumeMarkReadonlyResponse, UNARY_UNARY),
    "VolumeMarkWritable": (v.VolumeMarkWritableRequest, v.VolumeMarkWritableResponse, UNARY_UNARY),
    "VolumeMount": (v.VolumeMountRequest, v.VolumeMountResponse, UNARY_UNARY),
    "VolumeUnmount": (v.VolumeUnmountRequest, v.VolumeUnmountResponse, UNARY_UNARY),
    "VolumeSyncStatus": (v.VolumeSyncStatusRequest, v.VolumeSyncStatusResponse, UNARY_UNARY),
    "VolumeCopy": (v.VolumeCopyRequest, v.VolumeCopyResponse, UNARY_UNARY),
    "CopyFile": (v.CopyFileRequest, v.CopyFileResponse, UNARY_STREAM),
    "VolumeIncrementalCopy": (
        v.VolumeIncrementalCopyRequest,
        v.VolumeIncrementalCopyResponse,
        UNARY_STREAM,
    ),
    "VolumeEcShardsGenerate": (
        v.VolumeEcShardsGenerateRequest,
        v.VolumeEcShardsGenerateResponse,
        UNARY_UNARY,
    ),
    "VolumeEcShardsBatchGenerate": (
        v.VolumeEcShardsBatchGenerateRequest,
        v.VolumeEcShardsBatchGenerateResponse,
        UNARY_UNARY,
    ),
    "VolumeEcShardsRebuild": (
        v.VolumeEcShardsRebuildRequest,
        v.VolumeEcShardsRebuildResponse,
        UNARY_UNARY,
    ),
    # batch rebuild rides the BatchGenerate message pair (ids in,
    # empty response): the method table IS the service definition
    # here, so a new verb needs no proto regeneration as long as an
    # existing message shape fits
    "VolumeEcShardsBatchRebuild": (
        v.VolumeEcShardsBatchGenerateRequest,
        v.VolumeEcShardsBatchGenerateResponse,
        UNARY_UNARY,
    ),
    "VolumeEcShardsCopy": (v.VolumeEcShardsCopyRequest, v.VolumeEcShardsCopyResponse, UNARY_UNARY),
    "VolumeEcShardsDelete": (
        v.VolumeEcShardsDeleteRequest,
        v.VolumeEcShardsDeleteResponse,
        UNARY_UNARY,
    ),
    "VolumeEcShardsMount": (v.VolumeEcShardsMountRequest, v.VolumeEcShardsMountResponse, UNARY_UNARY),
    "VolumeEcShardsUnmount": (
        v.VolumeEcShardsUnmountRequest,
        v.VolumeEcShardsUnmountResponse,
        UNARY_UNARY,
    ),
    "VolumeEcShardRead": (v.VolumeEcShardReadRequest, v.VolumeEcShardReadResponse, UNARY_STREAM),
    "VolumeEcBlobDelete": (v.VolumeEcBlobDeleteRequest, v.VolumeEcBlobDeleteResponse, UNARY_UNARY),
    "VolumeEcShardsToVolume": (
        v.VolumeEcShardsToVolumeRequest,
        v.VolumeEcShardsToVolumeResponse,
        UNARY_UNARY,
    ),
    "VolumeTierMoveDatToRemote": (
        v.VolumeTierMoveDatToRemoteRequest,
        v.VolumeTierMoveDatToRemoteResponse,
        UNARY_STREAM,
    ),
    "VolumeTierMoveDatFromRemote": (
        v.VolumeTierMoveDatFromRemoteRequest,
        v.VolumeTierMoveDatFromRemoteResponse,
        UNARY_STREAM,
    ),
    "Query": (v.QueryRequest, v.QueriedStripe, UNARY_STREAM),
    "VolumeTailSender": (
        v.VolumeTailSenderRequest,
        v.VolumeTailSenderResponse,
        UNARY_STREAM,
    ),
    "VolumeTailReceiver": (
        v.VolumeTailReceiverRequest,
        v.VolumeTailReceiverResponse,
        UNARY_UNARY,
    ),
}


FILER_SERVICE = "seaweedfs_tpu.filer.Filer"
FILER_METHODS = {
    "LookupDirectoryEntry": (
        f.LookupDirectoryEntryRequest,
        f.LookupDirectoryEntryResponse,
        UNARY_UNARY,
    ),
    "ListEntries": (f.ListEntriesRequest, f.ListEntriesResponse, UNARY_STREAM),
    "CreateEntry": (f.CreateEntryRequest, f.CreateEntryResponse, UNARY_UNARY),
    "UpdateEntry": (f.UpdateEntryRequest, f.UpdateEntryResponse, UNARY_UNARY),
    "DeleteEntry": (f.DeleteEntryRequest, f.DeleteEntryResponse, UNARY_UNARY),
    "AtomicRenameEntry": (
        f.AtomicRenameEntryRequest,
        f.AtomicRenameEntryResponse,
        UNARY_UNARY,
    ),
    "AssignVolume": (f.AssignVolumeRequest, f.AssignVolumeResponse, UNARY_UNARY),
    "LookupVolume": (f.LookupVolumeRequest, f.LookupVolumeResponse, UNARY_UNARY),
    "DeleteCollection": (f.DeleteCollectionRequest, f.DeleteCollectionResponse, UNARY_UNARY),
    "Statistics": (f.StatisticsRequest, f.StatisticsResponse, UNARY_UNARY),
    "GetFilerConfiguration": (
        f.GetFilerConfigurationRequest,
        f.GetFilerConfigurationResponse,
        UNARY_UNARY,
    ),
}


def _deadline_guard(fn, kind):
    """Server-side deadline enforcement for every gRPC service bound
    through servicer_handler (docs/CHAOS.md): an `x-weed-deadline`
    metadata budget that arrived already expired aborts with
    DEADLINE_EXCEEDED before the method runs, and unary-response
    methods execute under the budget as the ambient deadline so their
    own downstream hops inherit it. Streaming-response methods get the
    fast-reject only — their generators run lazily on other threads,
    where a scoped thread-local would not follow."""
    unary_resp = kind in (UNARY_UNARY, STREAM_UNARY)

    def call(request, context):
        dl = _deadline.from_grpc_context(context) if _deadline.enabled() else None
        if dl is None:
            return fn(request, context)
        if dl.expired:
            context.abort(
                grpc.StatusCode.DEADLINE_EXCEEDED,
                "x-weed-deadline expired before dispatch",
            )
        if not unary_resp:
            return fn(request, context)
        with _deadline.scope(dl):
            return fn(request, context)

    return call


def servicer_handler(service_name: str, methods: dict, impl) -> grpc.GenericRpcHandler:
    """Bind `impl`'s methods (same names as the table) into a generic
    gRPC handler. Methods receive (request_or_iterator, context)."""
    handlers = {}
    for name, (req_cls, _resp_cls, kind) in methods.items():
        fn = getattr(impl, name)
        factory = getattr(grpc, f"{kind}_rpc_method_handler")
        handlers[name] = factory(
            _deadline_guard(fn, kind),
            request_deserializer=req_cls.FromString,
            response_serializer=lambda msg: msg.SerializeToString(),
        )
    return grpc.method_handlers_generic_handler(service_name, handlers)


def _traced_call(multicallable):
    """Auto-inject the current trace context as gRPC invocation
    metadata (docs/TRACING.md): ONE wrapper here propagates the
    `X-Weed-Trace` header across every internal gRPC hop — EC shard
    reads, copies, rebuild verbs, heartbeats — without touching call
    sites. Explicit metadata= wins (the EC readers capture context at
    factory time because their calls run on pool threads).

    Deadline plane (docs/CHAOS.md): the same wrapper derives each
    attempt's gRPC timeout from the ambient request deadline's
    REMAINING budget (min with any explicit timeout) and forwards the
    budget as `x-weed-deadline` metadata; an already-exhausted budget
    raises DeadlineExceeded without dialing."""

    def call(request, timeout=None, metadata=None, **kwargs):
        if metadata is None:
            from seaweedfs_tpu_torch.trace import grpc_metadata

            metadata = grpc_metadata()
        dl = _deadline.effective(None)
        if dl is not None:
            timeout = dl.cap(timeout)  # DeadlineExceeded when spent
            md = list(metadata) if metadata else []
            if not any(k == _deadline.DEADLINE_HEADER for k, _ in md):
                md.append((_deadline.DEADLINE_HEADER, dl.header_value()))
            metadata = md
        return multicallable(
            request, timeout=timeout, metadata=metadata, **kwargs
        )

    return call


class Stub:
    """Client stub: one callable attribute per method."""

    def __init__(self, channel: grpc.Channel, service_name: str, methods: dict):
        for name, (req_cls, resp_cls, kind) in methods.items():
            factory = getattr(channel, kind)
            setattr(
                self,
                name,
                _traced_call(
                    factory(
                        f"/{service_name}/{name}",
                        request_serializer=lambda msg: msg.SerializeToString(),
                        response_deserializer=resp_cls.FromString,
                    )
                ),
            )


RAFT_SERVICE = "seaweedfs_tpu.raft.Raft"
RAFT_METHODS = {
    "RequestVote": (r.RequestVoteRequest, r.RequestVoteResponse, UNARY_UNARY),
    "AppendEntries": (r.AppendEntriesRequest, r.AppendEntriesResponse, UNARY_UNARY),
}


def raft_stub(channel: grpc.Channel) -> Stub:
    return Stub(channel, RAFT_SERVICE, RAFT_METHODS)


def master_stub(channel: grpc.Channel) -> Stub:
    return Stub(channel, MASTER_SERVICE, MASTER_METHODS)


def volume_stub(channel: grpc.Channel) -> Stub:
    return Stub(channel, VOLUME_SERVICE, VOLUME_METHODS)


def filer_stub(channel: grpc.Channel) -> Stub:
    return Stub(channel, FILER_SERVICE, FILER_METHODS)


# --- TiKV raw-KV + PD routing (pingcap/kvproto wire) ------------------------
# Service full names are the REAL kvproto ones so these stubs speak to
# an actual PD/TiKV deployment; messages live in tikv.proto (semantic
# clone with kvproto field numbers). Used by filer/tikv_store.py and
# served offline by tests/cloud_fakes.FakeTikv.

from seaweedfs_tpu_torch.pb import tikv_pb2 as tk

PD_SERVICE = "pdpb.PD"
PD_METHODS = {
    "GetMembers": (tk.GetMembersRequest, tk.GetMembersResponse, UNARY_UNARY),
    "GetRegion": (tk.GetRegionRequest, tk.GetRegionResponse, UNARY_UNARY),
    "GetStore": (tk.GetStoreRequest, tk.GetStoreResponse, UNARY_UNARY),
}

TIKV_SERVICE = "tikvpb.Tikv"
TIKV_METHODS = {
    "RawGet": (tk.RawGetRequest, tk.RawGetResponse, UNARY_UNARY),
    "RawPut": (tk.RawPutRequest, tk.RawPutResponse, UNARY_UNARY),
    "RawDelete": (tk.RawDeleteRequest, tk.RawDeleteResponse, UNARY_UNARY),
    "RawDeleteRange": (
        tk.RawDeleteRangeRequest,
        tk.RawDeleteRangeResponse,
        UNARY_UNARY,
    ),
    "RawScan": (tk.RawScanRequest, tk.RawScanResponse, UNARY_UNARY),
}


def pd_stub(channel: grpc.Channel) -> Stub:
    return Stub(channel, PD_SERVICE, PD_METHODS)


def tikv_stub(channel: grpc.Channel) -> Stub:
    return Stub(channel, TIKV_SERVICE, TIKV_METHODS)
