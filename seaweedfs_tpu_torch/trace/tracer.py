"""Core tracer: spans, context propagation, and the completed-span ring.

Design constraints, in order:

  1. The volume write hot path budgets ~300 us of CPU per request, and
     on the bench host a single request's span lifecycle is dominated
     not by bytecode count but by COLD CACHE LINES — every distinct
     shared object the span path touches (contextvar HAMT nodes,
     metric dicts, lock objects) is evicted between requests and costs
     a miss when touched again. The hot path therefore touches almost
     nothing shared: context rides a per-thread cell (plain list) that
     stays warm on the connection's thread, the completed-span ring
     append is ONE GIL-atomic list store indexed off a C counter (no
     lock), and histogram aggregation is deferred — a background
     drainer (plus drain-on-read for operator endpoints and /metrics
     exposition, via the registry's prerender hook) folds ring entries
     into `weed_span_seconds` off the request path.
  2. `WEED_TRACE=0` (or set_enabled(False)) short-circuits at the one
     `enabled()` check each call site already guards on — a disabled
     tracer adds a module-global read per request and nothing else.
  3. Spans survive same-thread nesting via the cell's previous-span
     chain. Pool threads (EC readers, reconstruction fan-out) do NOT
     inherit the cell — those paths capture the wire context at
     factory time (trace.grpc_metadata()) instead, and cross-thread
     stages attach to the span object directly.

Wire format (`X-Weed-Trace`): `trace_id:parent_span_id:plane`, all
ASCII hex / lowercase tokens. The plane tag (`serve` | `scrub` |
`repair` | `tier`) travels with the trace so a volume server can see that an EC
shard read was rebuild traffic, not a user read — the cross-plane
interference the Facebook warehouse study (PAPERS.md, arXiv:1309.0186)
shows is otherwise invisible.
"""

from __future__ import annotations

import itertools
import os
import threading
import time

from seaweedfs_tpu_torch.stats.metrics import DEFAULT_REGISTRY, SPAN_HISTOGRAM
from seaweedfs_tpu_torch.util import wlog

TRACE_HEADER = "x-weed-trace"  # FastHeaders stores keys lowercased

PLANE_SERVE = "serve"

_ENABLED = os.environ.get("WEED_TRACE", "1") != "0"


def _pow2(n: int) -> int:
    return 1 << (n - 1).bit_length()


_RING_SIZE = _pow2(max(64, int(os.environ.get("WEED_TRACE_RING", "2048") or 2048)))
_RING_MASK = _RING_SIZE - 1
_SLOWEST_N = 32
_slow_threshold_ms = float(os.environ.get("WEED_TRACE_SLOW_MS", "0") or 0)
# Head sampling for mini-loop roots WITHOUT an inbound trace header:
# 1 = trace every request (full fidelity, the default); N traces every
# N-th. Requests carrying X-Weed-Trace always trace (internal hops and
# deliberate clients are never sampled away), so a sampled-in trace is
# always complete across its fan-out. Explicit span() calls (scrub,
# repair, EC drivers, bench roots) ignore sampling entirely.
_sample_every = max(1, int(os.environ.get("WEED_TRACE_SAMPLE", "1") or 1))
_sample_counter = itertools.count()

# ID minting: a random base per process XOR a counter — unique across
# restarts and across the cluster's processes without a syscall per
# request. Span ids need the base too: trace.dump merges spans from
# every daemon by span id, and bare counters collide across processes
# (every daemon's first span would be 00000001).
_id_base = int.from_bytes(os.urandom(8), "big")
_span_id_base = int.from_bytes(os.urandom(4), "big")
_trace_counter = itertools.count(1)
_span_counter = itertools.count(1)

# wall = _WALL_BASE + perf_counter(): one clock call per span instead
# of two; diagnostic timestamps tolerate the (NTP-step) drift
_WALL_BASE = time.time() - time.perf_counter()

_node_label = f"pid{os.getpid()}"


def set_node_label(label: str) -> None:
    """Default node tag for spans recorded without an explicit node
    (client-side spans, background planes). Servers pass their own
    host:port per request via span(..., node=...)."""
    global _node_label
    _node_label = label


def enabled() -> bool:
    return _ENABLED


def set_enabled(on: bool) -> None:
    """Runtime kill switch (bench.py A/B arms toggle this in-process)."""
    global _ENABLED
    _ENABLED = bool(on)


def sample_every() -> int:
    return _sample_every


def set_sample_every(n: int) -> None:
    """`-traceSample N`: head-sample 1-in-N headerless mini-loop roots
    (1 = every request). The overhead knob for hot fleets — see the
    bench `trace` config's sampled arm."""
    global _sample_every
    _sample_every = max(1, int(n))


def slow_threshold_ms() -> float:
    return _slow_threshold_ms


def set_slow_threshold_ms(ms: float) -> None:
    """`-traceSlowMs`: completed local-root spans slower than this are
    written through wlog with their request ID. 0 disables."""
    global _slow_threshold_ms
    _slow_threshold_ms = max(0.0, float(ms))


# --- per-thread context -------------------------------------------------
# One mutable cell per thread holding the innermost open span; open
# parents hang off the span's _prev chain. The cell is registered once
# per thread (for /debug/requests enumeration) and then every span
# entry/exit is two plain list stores on a warm object.

_tls = threading.local()
_cells: dict[int, list] = {}  # thread ident -> cell


def _cell() -> list:
    try:
        return _tls.cell
    except AttributeError:
        c = [None]
        _tls.cell = c
        with _lock:
            if len(_cells) > 1024:
                # prune dead threads' cells (thread-per-connection
                # servers retire threads constantly); amortized over
                # registrations, never on the request path
                alive = {t.ident for t in threading.enumerate()}
                for ident in [i for i in _cells if i not in alive]:
                    del _cells[ident]
            _cells[threading.get_ident()] = c
        return c


class Span:
    """One hop (or stage-bearing operation) of a traced request.

    Also the context manager that records itself: `with span(...)` is
    the only public way to open one, so every started span is
    guaranteed a ring record even when the handler raises.

    IDs are stored raw (ints for locally-minted, strings when
    inherited off the wire) and hex-formatted lazily by the
    `trace_id`/`span_id` properties — the volume leaf hop never reads
    them, so the hot path pays two counter bumps instead of two string
    formats."""

    __slots__ = (
        "_tid", "_sid", "parent_id", "name", "plane", "node",
        "t0", "duration", "status", "nbytes", "stages", "annot",
        "error", "_prev", "_cellref",
    )

    def __init__(
        self,
        name: str,
        tid,
        sid: int,
        parent_id: str,
        plane: str,
        node: str,
        nbytes: int,
        cell: list,
        t0: float = 0.0,
    ):
        self.name = name
        self._tid = tid  # int (local mint, XOR base at format) or str
        self._sid = sid  # int, formatted lazily
        self.parent_id = parent_id
        self.plane = plane
        self.node = node
        self.nbytes = nbytes
        self.t0 = t0 or time.perf_counter()
        self.duration = 0.0
        self.status = 0
        self.stages: dict[str, float] | None = None
        self.annot: dict[str, str] | None = None
        self.error = ""
        self._cellref = cell

    @property
    def trace_id(self) -> str:
        t = self._tid
        if type(t) is int:
            t = self._tid = "%016x" % (_id_base ^ t)
        return t

    @property
    def span_id(self) -> str:
        s = self._sid
        if type(s) is int:
            s = self._sid = "%08x" % (_span_id_base ^ s)
        return s

    # -- context manager -------------------------------------------------
    def __enter__(self) -> "Span":
        c = self._cellref
        self._prev = c[0]
        c[0] = self
        return self

    def __exit__(self, exc_type, exc, _tb) -> bool:
        # the finished-span sink, inlined: one clock read, the cell
        # restore, a C counter bump and a GIL-atomic list store; the
        # root-only extras (slowest table, slow-trace log) are gated on
        # plain float compares so the common case never locks
        self.duration = d = time.perf_counter() - self.t0
        if exc is not None and not self.error:
            self.error = f"{exc_type.__name__}: {exc}"[:200]
        self._cellref[0] = self._prev
        _ring[_ring_next() & _RING_MASK] = self
        _totals_add(self)
        if self.parent_id == "":
            if d > _slow_floor:
                _slow_insert(self)
            if _slow_threshold_ms > 0 and d * 1000.0 >= _slow_threshold_ms:
                _slow_log(self)
        if not _drainer_started:
            _start_drainer()
        return False  # never swallow

    # -- enrichment ------------------------------------------------------
    def add_stages(self, stages: dict[str, float]) -> None:
        """Attach stage timings. ADOPTS the dict when none is attached
        yet (callers hand over a per-request dict they never reuse)."""
        if self.stages is None:
            self.stages = stages
        else:
            self.stages.update(stages)

    def annotate(self, key: str, value) -> None:
        if self.annot is None:
            self.annot = {}
        self.annot[key] = str(value)[:200]

    @property
    def start(self) -> float:
        return _WALL_BASE + self.t0

    def to_dict(self) -> dict:
        d = {
            "trace": self.trace_id,
            "span": self.span_id,
            "parent": self.parent_id,
            "name": self.name,
            "plane": self.plane,
            "node": self.node,
            "start": round(self.start, 6),
            "dur_ms": round(self.duration * 1000.0, 3),
            "status": self.status,
            "bytes": self.nbytes,
        }
        if self.stages:
            d["stages_ms"] = {
                k: round(v * 1000.0, 3) for k, v in self.stages.items()
            }
        if self.annot:
            d["annot"] = self.annot
        if self.error:
            d["error"] = self.error
        return d


# --- completed-span ring ------------------------------------------------
# Preallocated list, power-of-two size. Writers never lock: slot index
# comes off a C counter (GIL-atomic) and the store is one list item
# assignment. _lock guards only the rare/cold paths: slowest-table
# updates, the drain cursor, thread-cell registration, and reset.

_lock = threading.Lock()
_ring: list[Span | None] = [None] * _RING_SIZE
_ring_counter = itertools.count()
_ring_next = _ring_counter.__next__  # bound once; reset() never rebinds
_reset_base = 0  # counter value at the last reset(); recorded = peek - base
_drained = 0  # ring positions (global numbering) already folded into SPAN_HISTOGRAM
# slowest local-root spans, UNSORTED on the hot path (sorted only when
# an operator reads debug_payload); _slow_floor caches min(_slow_durs)
# so the common case — a root span no slower than the current top-32
# floor — is ONE float compare, no lock
_slowest: list[Span] = []
_slow_durs: list[float] = []
_slow_floor = float("-inf")

_DRAIN_INTERVAL_S = 0.25
_drainer_started = False


def _peek() -> int:
    """Current ring-counter value (itertools.count peek — atomic)."""
    return _ring_counter.__reduce__()[1][0]


def _slow_insert(sp: Span) -> None:
    """Admit a root span into the slowest-N table. Reached only when
    its duration beats the cached floor, so the lock is rare."""
    global _slow_floor
    with _lock:
        if len(_slowest) < _SLOWEST_N:
            _slowest.append(sp)
            _slow_durs.append(sp.duration)
            if len(_slowest) == _SLOWEST_N:
                _slow_floor = min(_slow_durs)
        elif sp.duration > _slow_floor:
            i = _slow_durs.index(_slow_floor)
            _slowest[i] = sp
            _slow_durs[i] = sp.duration
            _slow_floor = min(_slow_durs)


def _slow_log(sp: Span) -> None:
    wlog.warning(
        "slow trace %s: %s %.1fms status=%s bytes=%d plane=%s stages=%s",
        sp.trace_id,
        sp.name,
        sp.duration * 1000.0,
        sp.status,
        sp.nbytes,
        sp.plane,
        {k: round(v * 1e3, 2) for k, v in (sp.stages or {}).items()},
    )


def drain() -> None:
    """Fold completed spans recorded since the last drain into the
    span-duration histogram. Runs on the drainer tick, before every
    /metrics exposition (registry prerender hook), and on operator
    reads — never on the request path. Spans overwritten before a
    drain (sustained > ring-size/interval load) are skipped; the exact
    per-request counters don't lose them."""
    global _drained
    put_exemplar = SPAN_HISTOGRAM.put_exemplar
    with _lock:
        cur = _peek()
        lo = max(_drained, cur - _RING_SIZE)
        for i in range(lo, cur):
            sp = _ring[i & _RING_MASK]
            if sp is not None:
                SPAN_HISTOGRAM.observe(sp.duration, sp.name, sp.plane)
                # weedscope exemplars: each bucket remembers the last
                # trace that landed in it — off the request path, here
                # in the drain, where the span is already in hand
                put_exemplar(sp.duration, sp.trace_id, sp.name, sp.plane)
        _drained = cur


def _start_drainer() -> None:
    global _drainer_started
    with _lock:
        if _drainer_started:
            return
        _drainer_started = True
    t = threading.Thread(target=_drain_loop, daemon=True, name="trace-drain")
    t.start()


def _drain_loop() -> None:
    while True:
        time.sleep(_DRAIN_INTERVAL_S)
        drain()


DEFAULT_REGISTRY.add_prerender_hook(drain)

# --- running totals and the recent list (the port's readers) ------------
# Spans closed through `with span(...)` also add to running totals per
# name, which outlast the ring: chip_smoke.py reads the degraded read's
# gather/decode seconds as deltas of them, and the port's tests read the
# last spans with `recent`.

_TOTALS: dict[str, dict] = {}
_totals_lock = threading.Lock()


def _totals_add(sp: "Span") -> None:
    with _totals_lock:
        tot = _TOTALS.get(sp.name)
        if tot is None:
            tot = _TOTALS[sp.name] = {
                "count": 0, "seconds": 0.0, "bytes": 0, "stages": {},
            }
        tot["count"] += 1
        tot["seconds"] += sp.duration
        tot["bytes"] += sp.nbytes
        for k, v in (sp.stages or {}).items():
            tot["stages"][k] = tot["stages"].get(k, 0.0) + v


def totals(name: str) -> dict:
    """Running totals of the closed spans named `name` since the process
    started: {"count", "seconds", "bytes", "stages": {stage: seconds}};
    read them as deltas around the work they measure."""
    with _totals_lock:
        tot = _TOTALS.get(name)
        if tot is None:
            return {"count": 0, "seconds": 0.0, "bytes": 0, "stages": {}}
        return {**tot, "stages": dict(tot["stages"])}


def recent(n: int = 64) -> list[dict]:
    """The last `n` finished spans in the ring, oldest first."""
    with _lock:
        cur = _peek()
        lo = max(cur - n, _reset_base, cur - _RING_SIZE)
        spans = [_ring[i & _RING_MASK] for i in range(lo, cur)]
    return [sp.to_dict() for sp in spans if sp is not None]


def reset() -> None:
    """Test hook: empty the ring, slowest table, and drain cursor. The
    counter itself is never replaced (its bound `__next__` lives in
    long-lived per-connection closures) — `_reset_base` rebases the
    recorded count instead."""
    global _reset_base, _drained, _slow_floor
    with _lock:
        for i in range(_RING_SIZE):
            _ring[i] = None
        _reset_base = _drained = _peek()
        del _slowest[:]
        del _slow_durs[:]
        _slow_floor = float("-inf")


# --- span construction --------------------------------------------------


def span(
    name: str,
    header: str | None = None,
    plane: str | None = None,
    nbytes: int = 0,
    node: str = "",
    t0: float = 0.0,
) -> "Span | _NullSpan":
    """Open a span: inherits trace id / parent / plane from the ambient
    context span if any, else from a wire `header`, else mints a fresh
    trace. Returns a no-op singleton when tracing is disabled so call
    sites stay a single `with trace.span(...) as sp:` either way.
    `t0` lets a caller that already read perf_counter share the clock
    sample instead of paying a second call."""
    if not _ENABLED:
        return _NULL
    try:
        c = _tls.cell
    except AttributeError:
        c = _cell()
    parent = c[0]
    if parent is not None:
        tid = parent._tid  # share raw; formats to the same hex
        parent_id = parent.span_id
        pl = plane or parent.plane
    else:
        tup = parse_header(header) if header else None
        if tup is not None:
            tid, parent_id, hdr_plane = tup
            pl = plane or hdr_plane or PLANE_SERVE
        else:
            tid = next(_trace_counter)  # XORed with _id_base at format
            parent_id = ""
            pl = plane or PLANE_SERVE
    return Span(
        name,
        tid,
        next(_span_counter),
        parent_id,
        pl,
        node or _node_label,
        nbytes,
        c,
        t0,
    )


def connection_tracer(node: str):
    """Per-connection span open/close pair for the mini request loop:
    every hot object the lifecycle touches — the thread's context
    cell, the Span class, the C counter bumps, the ring list, the
    clock — is captured in the closures, which stay warm on the
    connection's own thread across requests, and the context-manager
    protocol (two method dispatches per request) is bypassed. MUST be
    called on the thread that will serve the requests (the cell is
    that thread's).

    Returns `(open_span, close_span, sample_hit)`. `open_span(name,
    header, nbytes, t0)` returns an ALREADY-ENTERED Span, or _NULL
    when tracing is off (the `enabled()` check stays dynamic so the
    kill switch keeps working mid-connection). The caller must pair a
    truthy result with `close_span(sp, status)` in a finally block,
    and should consult `sample_hit()` for headerless requests before
    opening anything."""
    cell = _cell()
    node = node or _node_label
    span_cls = Span
    next_sid = _span_counter.__next__
    next_tid = _trace_counter.__next__
    parse = parse_header
    null = _NULL
    ring = _ring
    mask = _RING_MASK
    ring_next = _ring_next
    pc = time.perf_counter

    next_sample = _sample_counter.__next__

    def sample_hit() -> bool:
        """Head-sampling gate for a HEADERLESS request: the caller
        checks it BEFORE open_span so a sampled-out request runs the
        identical untraced branch (zero tracer objects touched).
        Full fidelity (N=1, the default) short-circuits to True."""
        return _sample_every == 1 or next_sample() % _sample_every == 0

    def open_span(name: str, header, nbytes: int, t0: float):
        if not _ENABLED:
            return null
        parent = cell[0]
        if parent is not None:
            tid = parent._tid
            parent_id = parent.span_id
            pl = parent.plane
        else:
            tup = parse(header) if header else None
            if tup is not None:
                tid, parent_id, pl = tup
            else:
                tid = next_tid()
                parent_id = ""
                pl = PLANE_SERVE
        sp = span_cls(
            name, tid, next_sid(), parent_id, pl, node, nbytes, cell, t0
        )
        sp._prev = parent
        cell[0] = sp
        return sp

    def close_span(sp, status: int):
        sp.duration = d = pc() - sp.t0
        sp.status = status
        cell[0] = sp._prev
        ring[ring_next() & mask] = sp
        if sp.parent_id == "":
            if d > _slow_floor:
                _slow_insert(sp)
            if _slow_threshold_ms > 0 and d * 1000.0 >= _slow_threshold_ms:
                _slow_log(sp)
        if not _drainer_started:
            _start_drainer()

    return open_span, close_span, sample_hit


def loop_tracer(node: str):
    """Span mint/close pair for the EVENT-DRIVEN serving loop (the C
    epoll core, docs/SERVING.md): like connection_tracer, but
    nesting-free. The epoll loop interleaves many in-flight requests
    on ONE thread — open A, open B, close A through the thread's
    context cell would corrupt the restore stack — so each fast-path
    span rides its own throwaway cell and never becomes ambient
    context. Fast-path GETs are leaf hops that make no further calls,
    so nothing downstream needs the ambient span anyway; cross-hop
    parentage still comes from the request's X-Weed-Trace header.

    Returns `(open_span, close_span, sample_hit)`; open_span(name,
    header, nbytes, t0) -> Span | None (tracing off)."""
    node = node or _node_label
    span_cls = Span
    next_sid = _span_counter.__next__
    next_tid = _trace_counter.__next__
    parse = parse_header
    ring = _ring
    mask = _RING_MASK
    ring_next = _ring_next
    pc = time.perf_counter
    next_sample = _sample_counter.__next__

    def sample_hit() -> bool:
        return _sample_every == 1 or next_sample() % _sample_every == 0

    def open_span(name: str, header, nbytes: int, t0: float):
        if not _ENABLED:
            return None
        tup = parse(header) if header else None
        if tup is not None:
            tid, parent_id, pl = tup
        else:
            tid = next_tid()
            parent_id = ""
            pl = PLANE_SERVE
        cell = [None]
        sp = span_cls(name, tid, next_sid(), parent_id, pl, node, nbytes, cell, t0)
        sp._prev = None
        cell[0] = sp
        return sp

    def close_span(sp, status: int) -> None:
        sp.duration = d = pc() - sp.t0
        sp.status = status
        sp._cellref[0] = None
        ring[ring_next() & mask] = sp
        if sp.parent_id == "":
            if d > _slow_floor:
                _slow_insert(sp)
            if _slow_threshold_ms > 0 and d * 1000.0 >= _slow_threshold_ms:
                _slow_log(sp)
        if not _drainer_started:
            _start_drainer()

    return open_span, close_span, sample_hit


class _NullSpan:
    """Disabled-tracer stand-in: every method a no-op, `if sp:` False."""

    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False

    def __bool__(self):
        return False

    def add_stages(self, stages):
        pass

    def annotate(self, key, value):
        pass

    status = 0
    nbytes = 0
    duration = 0.0
    error = ""


_NULL = _NullSpan()


def current() -> Span | None:
    try:
        return _tls.cell[0]
    except AttributeError:
        return None


def current_trace_id() -> str:
    sp = current()
    return sp.trace_id if sp is not None else ""


def add_stages(stages: dict[str, float]) -> None:
    """Attach stage timings to the current span (no-op untraced)."""
    sp = current()
    if sp is not None:
        sp.add_stages(stages)


def annotate(key: str, value) -> None:
    sp = current()
    if sp is not None:
        sp.annotate(key, value)


# wlog consults this per LOG LINE (not per request) so every line
# emitted inside a traced request is prefixed with its request id
wlog.set_request_id_provider(current_trace_id)


# --- wire format --------------------------------------------------------


def format_header(sp: Span) -> str:
    return f"{sp.trace_id}:{sp.span_id}:{sp.plane}"


_HEXDIGITS = frozenset("0123456789abcdefABCDEF")


def _ishex(s: str) -> bool:
    return all(c in _HEXDIGITS for c in s)


def parse_header(value: str) -> tuple[str, str, str] | None:
    """`trace:parent:plane` -> tuple, or None when malformed. Tokens are
    length-capped: the header crosses trust boundaries (a public client
    can send one) and must never become an unbounded stored string."""
    if not value or len(value) > 128:
        return None
    parts = value.split(":")
    if len(parts) != 3:
        return None
    trace_id, parent_id, plane = parts
    if not trace_id or len(trace_id) > 32 or len(parent_id) > 32:
        return None
    # ids must be hex: they end up inside log-format strings (wlog's
    # [trace_id] prefix) and shell output, so a public client must not
    # be able to smuggle '%' or control characters through the header
    if not _ishex(trace_id) or (parent_id and not _ishex(parent_id)):
        return None
    if plane not in ("serve", "scrub", "repair", "tier"):
        plane = PLANE_SERVE
    return trace_id, parent_id, plane


def header_value() -> str | None:
    """The `X-Weed-Trace` value for an outbound hop under the current
    span, or None when untraced/disabled."""
    if not _ENABLED:
        return None
    sp = current()
    return format_header(sp) if sp is not None else None


def inject(headers: dict) -> dict:
    """Add the trace header to an outbound header dict (mutates and
    returns it). The single call every internal HTTP hop makes."""
    v = header_value()
    if v is not None:
        headers[TRACE_HEADER] = v
    return headers


def inject_request(req) -> None:
    """Stamp the current span's context onto an outbound
    urllib.request.Request — the HTTP-object twin of inject()."""
    v = header_value()
    if v is not None:
        req.add_header(TRACE_HEADER, v)


def grpc_metadata() -> tuple | None:
    """Invocation metadata for an outbound gRPC hop (VolumeEcShardRead
    et al.), or None when untraced."""
    v = header_value()
    return ((TRACE_HEADER, v),) if v is not None else None


def header_from_grpc_context(context) -> str | None:
    """Pull the trace header off a servicer context's metadata."""
    try:
        for k, v in context.invocation_metadata() or ():
            if k == TRACE_HEADER:
                return v
    except Exception:  # noqa: BLE001 — tracing must never fail a verb
        return None
    return None


# --- operator surfaces --------------------------------------------------


def debug_payload(n: int = 64) -> dict:
    """`/debug/traces`: tracer state + recent and slowest-N completed
    spans (?n= caps the recent list; n=0 returns only the meta)."""
    drain()
    with _lock:
        cur = _peek()
        total = cur - _reset_base
        count = min(total, _RING_SIZE, max(0, n))
        recent = [
            _ring[(cur - 1 - i) & _RING_MASK] for i in range(count)
        ]
        slowest = sorted(_slowest, key=lambda s: s.duration, reverse=True)
    inflight = _open_spans()
    return {
        "node": _node_label,
        "enabled": _ENABLED,
        "ring_size": _RING_SIZE,
        "recorded": total,
        "dropped": max(0, total - _RING_SIZE),
        "slow_ms": _slow_threshold_ms,
        "inflight": len(inflight),
        "recent": [s.to_dict() for s in recent if s is not None],
        "slowest": [s.to_dict() for s in slowest],
    }


def _open_spans() -> list[Span]:
    """Every currently-open span across threads: walk each registered
    thread cell's previous-span chain. Cells of dead threads are
    dropped along the way."""
    alive = {t.ident for t in threading.enumerate()}
    spans: list[Span] = []
    with _lock:
        for ident in list(_cells):
            if ident not in alive:
                del _cells[ident]
                continue
            sp = _cells[ident][0]
            while sp is not None:
                spans.append(sp)
                sp = sp._prev
    return spans


def inflight_payload() -> dict:
    """`/debug/requests`: spans currently open in this process."""
    now = time.perf_counter()
    return {
        "node": _node_label,
        "inflight": [
            {
                "trace": s.trace_id,
                "span": s.span_id,
                "parent": s.parent_id,
                "name": s.name,
                "plane": s.plane,
                "age_ms": round((now - s.t0) * 1000.0, 3),
                "bytes": s.nbytes,
            }
            for s in _open_spans()
        ],
    }


def _vlog_enabled(level: int = 2) -> bool:
    """Whether verbose tracing logs are on for THIS module — the
    set_vmodule('tracer=N') probe tests/test_trace.py exercises."""
    return bool(wlog.V(level))
