"""Spans for the EC pipelines and the degraded read: the part of
seaweedfs_tpu/trace/tracer.py that ec_stream and ec_volume touch.

A span records a name, its plane (the traffic class it serves:
"serve" unless the caller names another, as the reference defaults a
span without a parent), a byte count, its wall duration, the pipeline's
per-stage busy seconds (`add_stages`) and annotations, and lands in a
bounded ring of recent spans when it closes. Closed spans also add to
running totals per name (`totals`: count, seconds, bytes and stage
seconds), which outlast the ring. The reference's wire propagation,
sampling and debug endpoints are not part of the port.
"""

from __future__ import annotations

import collections
import threading
import time

PLANE_SERVE = "serve"

_RING = collections.deque(maxlen=256)
_TOTALS: dict[str, dict] = {}
_ring_lock = threading.Lock()


class Span:
    __slots__ = ("name", "plane", "nbytes", "t0", "duration", "stages", "annot", "error")

    def __init__(self, name: str, nbytes: int = 0, plane: str = PLANE_SERVE):
        self.name = name
        self.plane = plane
        self.nbytes = nbytes
        self.t0 = 0.0
        self.duration = 0.0
        self.stages: dict[str, float] = {}
        self.annot: dict[str, str] = {}
        self.error = ""

    def __enter__(self) -> "Span":
        self.t0 = time.perf_counter()
        return self

    def __exit__(self, exc_type, exc, _tb) -> bool:
        self.duration = time.perf_counter() - self.t0
        if exc is not None:
            self.error = f"{exc_type.__name__}: {exc}"[:200]
        with _ring_lock:
            _RING.append(self)
            tot = _TOTALS.get(self.name)
            if tot is None:
                tot = _TOTALS[self.name] = {"count": 0, "seconds": 0.0, "bytes": 0,
                                            "stages": {}}
            tot["count"] += 1
            tot["seconds"] += self.duration
            tot["bytes"] += self.nbytes
            for k, v in self.stages.items():
                tot["stages"][k] = tot["stages"].get(k, 0.0) + v
        return False  # never swallow

    def add_stages(self, stages: dict[str, float]) -> None:
        self.stages.update(stages)

    def annotate(self, key: str, value) -> None:
        self.annot[key] = str(value)[:200]

    def to_dict(self) -> dict:
        return {
            "name": self.name,
            "plane": self.plane,
            "bytes": self.nbytes,
            "dur_ms": self.duration * 1000.0,
            "stages_ms": {k: v * 1000.0 for k, v in self.stages.items()},
            "annot": dict(self.annot),
            "error": self.error,
        }


def span(name: str, nbytes: int = 0, plane: str | None = None) -> Span:
    """Open a span: `with span("ec_stream.encode", nbytes=n) as sp:`;
    `plane` tags its traffic class (`span("ec.degraded", plane="serve",
    nbytes=n)`, as seaweedfs_tpu/trace/tracer.py:402 takes it)."""
    return Span(name, nbytes, plane or PLANE_SERVE)


def recent(n: int = 64) -> list[dict]:
    """The last `n` finished spans, oldest first."""
    with _ring_lock:
        spans = list(_RING)[-n:]
    return [s.to_dict() for s in spans]


def totals(name: str) -> dict:
    """Running totals of the closed spans named `name` since the process
    started: {"count", "seconds", "bytes", "stages": {stage: seconds}};
    read them as deltas around the work they measure."""
    with _ring_lock:
        tot = _TOTALS.get(name)
        if tot is None:
            return {"count": 0, "seconds": 0.0, "bytes": 0, "stages": {}}
        return {**tot, "stages": dict(tot["stages"])}
