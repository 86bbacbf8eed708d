"""Distributed request tracing plane (docs/TRACING.md).

Every serving entry point mints or inherits a request (trace) ID, each
hop records a span into a lock-cheap per-process ring buffer, and the
`X-Weed-Trace` header carries `trace_id:parent_span_id:plane` across
every internal HTTP and gRPC hop — replica fan-out, `x-shard-hop`
worker forwarding, EC remote shard reads, scrub/repair rebuild traffic.
"""

from seaweedfs_tpu_torch.trace.tracer import (
    TRACE_HEADER,
    Span,
    add_stages,
    annotate,
    connection_tracer,
    current,
    current_trace_id,
    debug_payload,
    enabled,
    format_header,
    grpc_metadata,
    header_from_grpc_context,
    header_value,
    inflight_payload,
    inject,
    inject_request,
    loop_tracer,
    parse_header,
    recent,
    reset,
    sample_every,
    set_enabled,
    set_sample_every,
    set_slow_threshold_ms,
    slow_threshold_ms,
    span,
    totals,
)

__all__ = [
    "TRACE_HEADER",
    "Span",
    "add_stages",
    "annotate",
    "connection_tracer",
    "current",
    "current_trace_id",
    "debug_payload",
    "enabled",
    "format_header",
    "grpc_metadata",
    "header_from_grpc_context",
    "header_value",
    "inflight_payload",
    "inject",
    "inject_request",
    "loop_tracer",
    "parse_header",
    "recent",
    "reset",
    "sample_every",
    "set_enabled",
    "set_sample_every",
    "set_slow_threshold_ms",
    "slow_threshold_ms",
    "span",
    "totals",
]
