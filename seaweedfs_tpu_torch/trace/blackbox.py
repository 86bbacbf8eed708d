"""Always-on per-daemon flight recorder (weedscope, docs/TRACING.md).

A bounded ring of structured wide-events — one per completed request:
trace id, plane, status, duration, stage timings, peer, bytes, and the
hedge/retry/shed/deadline flags — fed from the same two funnels the
trace plane uses (util/httpd.serve_connection and the C fast path's
complete() callback in util/native_serve). Unlike the span ring, which
head-samples and exists to be drained into histograms, the blackbox is
the post-hoc evidence store: when an SLO burns, the capsule snapshot
of this ring is what shows WHICH requests were slow or failing and how
their stages split, minutes after the fact.

Retention is TAIL-BIASED, two rings:

  * the tail ring keeps EVERY error (status >= 400) and every slow
    request (duration >= WEED_SCOPE_SLOW_MS);
  * the ok ring keeps 1-in-N sampled successes (WEED_SCOPE_OK_EVERY)
    so the baseline is always on hand for comparison without OK
    traffic flushing the interesting tail out of a single ring.

Hot-path economy follows the tracer's cold-line rule: a recorder is a
closure holding preallocated rings and bound C counters; recording an
OK request that loses the 1-in-N draw is one counter bump and a modulo
— no tuple is even built. `WEED_SCOPE=0` turns the whole plane off
(record() returns at one module-global check).

Records are plain tuples (no class, no __dict__):

    (wall, name, trace_id, plane, status, dur_s, nbytes, peer,
     flags, stages)

`flags` is a bitmask (FLAG_HEDGE|FLAG_RETRY|FLAG_SHED|FLAG_DEADLINE);
`stages` is the span's stage dict (shared, never mutated after close)
or None.
"""

from __future__ import annotations

import itertools
import os
import threading
import time

FLAG_HEDGE = 1     # request carried the x-weed-hedge hop header
FLAG_RETRY = 2     # request carried the x-weed-retry hop header
FLAG_SHED = 4      # 503: admission control / lame-duck shed
FLAG_DEADLINE = 8  # 504: X-Weed-Deadline expired

_FLAG_NAMES = (
    (FLAG_HEDGE, "hedge"),
    (FLAG_RETRY, "retry"),
    (FLAG_SHED, "shed"),
    (FLAG_DEADLINE, "deadline"),
)

_ENABLED = os.environ.get("WEED_SCOPE", "1") != "0"


def _pow2(n: int) -> int:
    return 1 << (n - 1).bit_length()


_RING_SIZE = _pow2(max(64, int(os.environ.get("WEED_SCOPE_RING", "1024") or 1024)))
_RING_MASK = _RING_SIZE - 1
_OK_EVERY = max(1, int(os.environ.get("WEED_SCOPE_OK_EVERY", "16") or 16))
_SLOW_S = float(os.environ.get("WEED_SCOPE_SLOW_MS", "100") or 100) / 1000.0

# the two rings: writers never lock (slot index off a C counter,
# GIL-atomic list store — the tracer ring's idiom)
_tail: list[tuple | None] = [None] * _RING_SIZE
_tail_counter = itertools.count()
_tail_next = _tail_counter.__next__
_ok: list[tuple | None] = [None] * _RING_SIZE
_ok_counter = itertools.count()
_ok_next = _ok_counter.__next__
_sample_counter = itertools.count()

_lock = threading.Lock()  # snapshot/reset only — never the record path
_reset_tail = 0
_reset_ok = 0

# wall = base + perf_counter(), the tracer's one-clock-call trick
_WALL_BASE = time.time() - time.perf_counter()


def enabled() -> bool:
    return _ENABLED


def set_enabled(on: bool) -> None:
    """Runtime kill switch (WEED_SCOPE=0 sets the boot default; bench
    A/B arms and tests flip it in-process)."""
    global _ENABLED
    _ENABLED = bool(on)


def slow_threshold_s() -> float:
    return _SLOW_S


def recorder(name_prefix: str, node: str):
    """Build the per-server record closure the dispatch funnels call
    once per completed request:

        record(method, trace_id, plane, status, dur_s, nbytes, peer,
               flags, stages)

    Everything the per-request path touches is hoisted into closure
    locals (the docs/TRACING.md cold-line rule); `name_prefix` becomes
    the event name prefix (`volume.GET`)."""
    tail = _tail
    mask = _RING_MASK
    tail_next = _tail_next
    ok = _ok
    ok_next = _ok_next
    next_sample = _sample_counter.__next__
    ok_every = _OK_EVERY
    slow_s = _SLOW_S
    wall_base = _WALL_BASE
    pc = time.perf_counter
    prefix = (name_prefix or "http") + "."

    def record(
        method: str,
        trace_id: str,
        plane: str,
        status: int,
        dur_s: float,
        nbytes: int,
        peer: str,
        flags: int,
        stages,
    ) -> None:
        if not _ENABLED:
            return
        if status < 400 and dur_s < slow_s and flags == 0:
            # the common case: an unremarkable OK. Decide 1-in-N BEFORE
            # building anything — a lost draw costs one bump + modulo.
            if ok_every != 1 and next_sample() % ok_every:
                return
            ring, nxt = ok, ok_next
        else:
            ring, nxt = tail, tail_next
        ring[nxt() & mask] = (
            wall_base + pc(),
            prefix + method,
            trace_id,
            plane,
            status,
            dur_s,
            nbytes,
            peer,
            flags,
            stages,
        )

    return record


def request_flags(headers, status: int) -> int:
    """Flag bitmask for a completed request: hop headers mark hedged
    and retried attempts (the sending sides stamp x-weed-hedge /
    x-weed-retry), the status marks shed (503) and expired-deadline
    (504) outcomes."""
    flags = 0
    if headers.get("x-weed-hedge") is not None:
        flags |= FLAG_HEDGE
    if headers.get("x-weed-retry") is not None:
        flags |= FLAG_RETRY
    if status == 503:
        flags |= FLAG_SHED
    elif status == 504:
        flags |= FLAG_DEADLINE
    return flags


def _dump(rec: tuple) -> dict:
    wall, name, trace_id, plane, status, dur_s, nbytes, peer, flags, stages = rec
    d = {
        "t": round(wall, 3),
        "name": name,
        "trace": trace_id,
        "plane": plane,
        "status": status,
        "dur_ms": round(dur_s * 1000.0, 3),
        "bytes": nbytes,
        "peer": peer,
    }
    if flags:
        d["flags"] = [n for bit, n in _FLAG_NAMES if flags & bit]
    if stages:
        d["stages_ms"] = {k: round(v * 1000.0, 3) for k, v in stages.items()}
    return d


def _peek(counter: itertools.count) -> int:
    return counter.__reduce__()[1][0]


def _ring_slice(ring: list, counter: itertools.count, n: int) -> list[tuple]:
    cur = _peek(counter)
    count = min(cur, _RING_SIZE, max(0, n))
    out = []
    for i in range(count):
        rec = ring[(cur - 1 - i) & _RING_MASK]
        if rec is not None:
            out.append(rec)
    return out


def snapshot(n: int = 256) -> dict:
    """`/debug/blackbox` and the capsule's flight-recorder section:
    newest-first tail (errors + slow) and sampled-OK records, plus the
    recorder's own accounting so "0 interesting events" is
    distinguishable from "recorder off"."""
    with _lock:
        tail_total = _peek(_tail_counter) - _reset_tail
        ok_total = _peek(_ok_counter) - _reset_ok
        tail = _ring_slice(_tail, _tail_counter, n)
        oks = _ring_slice(_ok, _ok_counter, n)
    return {
        "enabled": _ENABLED,
        "ring_size": _RING_SIZE,
        "ok_every": _OK_EVERY,
        "slow_ms": _SLOW_S * 1000.0,
        "tail_recorded": tail_total,
        "ok_recorded": ok_total,
        "tail": [_dump(r) for r in tail],
        "ok": [_dump(r) for r in oks],
    }


def reset() -> None:
    """Test hook: empty both rings (the counters are never replaced —
    their bound __next__ lives in per-server recorder closures)."""
    global _reset_tail, _reset_ok
    with _lock:
        for i in range(_RING_SIZE):
            _tail[i] = None
            _ok[i] = None
        _reset_tail = _peek(_tail_counter)
        _reset_ok = _peek(_ok_counter)
