"""Continuous sampling profiler: folded stacks on every daemon.

Generalizes util/profiling.CpuProfile (one-shot, instrumenting, whole-
run) into an always-on statistical sampler cheap enough for production
serving (the <=1% bound is enforced by bench.py's `load` config): a
single background thread wakes every WEED_PROF_MS milliseconds, grabs
`sys._current_frames()` (one C call), walks each thread's frame chain,
and bumps a counter keyed by the stack tuple. No per-call hooks, no
sys.setprofile — the serving path is never instrumented, only observed
while the sampler briefly holds the GIL.

Cost engineering: frame-walk labels are interned per code object
(id(code) → "module:qualname" built once), so a tick is N_threads ×
stack_depth dict lookups plus one counter bump — single-digit
microseconds per thread at the default 10 ms period (~0.1% of one
core). The aggregate is a plain dict guarded by one lock taken per
tick and per snapshot, never on any request path.

Operator surface: every daemon serves `/debug/profile?seconds=S`
through the mini request loop (util/httpd._serve_debug): snapshot,
wait S seconds, diff — a flamegraph-ready folded-stack view of exactly
that window. `?fmt=folded` emits flamegraph.pl input; default JSON.
"""

from __future__ import annotations

import os
import sys
import threading
import time

_ENABLED = os.environ.get("WEED_PROF", "1") != "0"
try:
    _INTERVAL_S = max(1.0, float(os.environ.get("WEED_PROF_MS", "10") or 10)) / 1000.0
except ValueError:
    # a malformed tuning knob must never keep a serving daemon from
    # booting (every daemon's start() imports this module)
    _INTERVAL_S = 0.010

# sampling state: one process-wide sampler, shared by every daemon of
# the process: each start() counts itself on it, each stop() releases
# it, and the thread ends with its last user
_lock = threading.Lock()
_counts: dict[tuple[str, ...], int] = {}
_samples = 0
_started = False
_users = 0
_thread: threading.Thread | None = None
_stop: threading.Event | None = None
_paused = False
_started_at = 0.0
_label_cache: dict[int, str] = {}


def _label(frame) -> str:
    code = frame.f_code
    lab = _label_cache.get(id(code))
    if lab is None:
        mod = frame.f_globals.get("__name__", "?")
        lab = _label_cache[id(code)] = f"{mod}.{code.co_name}"
        if len(_label_cache) > 65536:
            # id() reuse after code-object churn could alias labels;
            # cap the cache instead of letting it grow forever
            _label_cache.clear()
            _label_cache[id(code)] = lab
    return lab


def _tick(me: int) -> list[tuple[str, ...]]:
    """One sample: every other thread's stack, outermost first. The
    frames die when this returns: a frame held across the sleep would
    keep its thread's locals alive and then free them here, on the
    sampler's thread (a CUDA graph or a pinned buffer among them)."""
    ticks: list[tuple[str, ...]] = []
    for ident, frame in sys._current_frames().items():
        if ident == me:
            continue
        stack: list[str] = []
        depth = 0
        while frame is not None and depth < 64:
            stack.append(_label(frame))
            frame = frame.f_back
            depth += 1
        stack.reverse()  # outermost first: flamegraph fold order
        ticks.append(tuple(stack))
    return ticks


def _sample_loop(stop: threading.Event) -> None:
    global _samples
    me = threading.get_ident()
    while not stop.wait(_INTERVAL_S):
        if _paused:
            continue
        ticks = _tick(me)
        with _lock:
            _samples += 1
            for key in ticks:
                _counts[key] = _counts.get(key, 0) + 1


def _start_locked() -> None:
    global _started, _started_at, _thread, _stop
    if _started:
        return
    _started = True
    _started_at = time.time()
    _stop = threading.Event()
    _thread = threading.Thread(
        target=_sample_loop, args=(_stop,), daemon=True, name="prof-sampler"
    )
    _thread.start()


def ensure_started() -> bool:
    """Start the process-wide sampler, or count one more daemon on it:
    every daemon's start() calls this and its stop() calls release().
    WEED_PROF=0 keeps the process sampler-free."""
    global _users
    if not _ENABLED:
        return False
    with _lock:
        _users += 1
        _start_locked()
    return True


def release() -> None:
    """A daemon's stop(): the sampler's thread ends, joined, with its
    last user."""
    global _users, _started, _thread
    with _lock:
        if _users == 0:
            return
        _users -= 1
        if _users or not _started:
            return
        _started = False
        _stop.set()
        thread, _thread = _thread, None
    thread.join()


def set_paused(paused: bool) -> None:
    """bench A/B seam: stop sampling without killing the thread."""
    global _paused
    _paused = bool(paused)


def running() -> bool:
    return _started and not _paused


def snapshot() -> tuple[int, dict[tuple[str, ...], int]]:
    with _lock:
        return _samples, dict(_counts)


def capture(seconds: float) -> dict:
    """Folded-stack aggregate over the NEXT `seconds` (snapshot → wait
    → diff). seconds <= 0 returns the since-start aggregate, empty when
    no daemon runs the sampler. The wait parks only the calling
    (operator request) thread, which counts itself as a user of the
    sampler for the window, so no thread outlives it unowned."""
    if seconds > 0:
        held = ensure_started()
        try:
            s0, c0 = snapshot()
            # hot-loop exemption (analysis/hotloop._EXEMPT_QUALS): this
            # sleep parks only the requesting operator connection's
            # thread for the capped capture window — it IS the capture
            time.sleep(min(seconds, 60.0))
            s1, c1 = snapshot()
        finally:
            if held:
                release()
        samples = s1 - s0
        window = {
            k: n - c0.get(k, 0) for k, n in c1.items() if n - c0.get(k, 0) > 0
        }
        span = seconds
    elif _started:
        samples, window = snapshot()
        span = time.time() - _started_at if _started_at else 0.0
    else:
        samples, window, span = 0, {}, 0.0
    return {
        "enabled": _ENABLED,
        "running": running(),
        "interval_ms": _INTERVAL_S * 1000.0,
        "seconds": round(span, 3),
        "samples": samples,
        "stacks": {";".join(k): n for k, n in window.items()},
    }


def render_folded(payload: dict) -> str:
    """flamegraph.pl-ready text: `a;b;c N` per line, hottest first."""
    stacks = payload.get("stacks", {})
    lines = [
        f"{stack} {n}"
        for stack, n in sorted(stacks.items(), key=lambda kv: -kv[1])
    ]
    return "\n".join(lines) + ("\n" if lines else "")


def reset() -> None:
    """Test hook: clear aggregates (the thread keeps running)."""
    global _samples
    with _lock:
        _counts.clear()
        _samples = 0
