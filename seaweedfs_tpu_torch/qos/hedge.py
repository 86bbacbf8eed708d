"""Hedged replica reads: fire a second GET when the first runs long.

The classic tied-request defense (Dean & Barroso, "The Tail at Scale"):
a read that has not answered within an adaptive delay — tracked
per-volume as a latency quantile, NOT a fixed timer — fires a second
attempt at the next replica, takes whichever answers first, and tears
down the loser's connection so the slow server stops working on it.
The second attempt carries the `x-weed-hedge` hop header so servers
can tell tied reads from first attempts (they count them and annotate
the span; the loser's socket teardown is the cancel signal).

Used by weedload's hedged GET workers (and, in the reference, by the
filer chunk-read path the S3 and WebDAV gateways read through).
`WEED_QOS=0` / `WEED_QOS_HEDGE=0` routes every read back through the
plain pooled single-attempt path wholesale.

Why not the op.http_call pool: cancellation closes a socket mid-
response, which a shared keep-alive pool must never see. Attempts
check connections out of a small dedicated pool; a cancelled attempt's
connection is closed and never returned.

The port of seaweedfs_tpu/qos/hedge.py. `gather_first_k`, the k-of-n
gather the EC degraded read runs over shard survivors, shares the
attempt workers (_AttemptPool says where the port's pool differs).
"""

from __future__ import annotations

import http.client
import io
import os
import queue
import threading
import time
import urllib.error

from seaweedfs_tpu_torch import trace
from seaweedfs_tpu_torch import qos
from seaweedfs_tpu_torch.client import vid_map as _vm
from seaweedfs_tpu_torch.stats.metrics import (
    HEDGE_CANCELLED,
    HEDGE_FIRED,
    HEDGE_WON,
)

_MIN_DELAY_S = 0.001
_SAMPLES_FOR_QUANTILE = 16


def _initial_delay_s() -> float:
    """Hedge delay before a volume has latency history (and the floor
    the adaptive delay decays toward): WEED_QOS_HEDGE_MS, default 25."""
    try:
        return float(os.environ.get("WEED_QOS_HEDGE_MS", "25")) / 1000.0
    except ValueError:
        return 0.025


def _max_delay_s() -> float:
    """Adaptive-delay ceiling: WEED_QOS_HEDGE_MAX_MS, default 1000."""
    try:
        return float(os.environ.get("WEED_QOS_HEDGE_MAX_MS", "1000")) / 1000.0
    except ValueError:
        return 1.0


class LatencyTracker:
    """Per-key ring of recent winner latencies; the hedge delay is the
    p95 of the ring (clamped), so a volume that usually answers in 2 ms
    hedges at ~2 ms while a 50 ms volume waits 50 ms — a fixed timer
    would either hedge everything or nothing."""

    _RING = 64

    def __init__(self) -> None:
        self._lock = threading.Lock()
        self._rings: dict[object, list[float]] = {}
        self._pos: dict[object, int] = {}

    def record(self, key, seconds: float) -> None:
        with self._lock:
            ring = self._rings.get(key)
            if ring is None:
                ring = self._rings[key] = []
                self._pos[key] = 0
                if len(self._rings) > 4096:  # bound: forget oldest keys
                    for stale in list(self._rings)[:1024]:
                        if stale != key:
                            self._rings.pop(stale, None)
                            self._pos.pop(stale, None)
            if len(ring) < self._RING:
                ring.append(seconds)
            else:
                ring[self._pos[key]] = seconds
                self._pos[key] = (self._pos[key] + 1) % self._RING

    def delay_s(self, key) -> float:
        with self._lock:
            ring = list(self._rings.get(key, ()))
        if len(ring) < _SAMPLES_FOR_QUANTILE:
            return _initial_delay_s()
        ring.sort()
        p95 = ring[min(len(ring) - 1, int(len(ring) * 0.95))]
        return min(max(p95, _MIN_DELAY_S), _max_delay_s())


class _ConnPool:
    """Tiny keep-alive pool attempts check connections OUT of (so a
    cancel can close a socket that is provably owned by one attempt)."""

    _PER_HOST = 4

    def __init__(self) -> None:
        self._lock = threading.Lock()
        self._idle: dict[str, list] = {}

    def checkout(self, netloc: str, timeout: float):
        with self._lock:
            idle = self._idle.get(netloc)
            if idle:
                c = idle.pop()
                c.settimeout(timeout)
                return c, True
        from seaweedfs_tpu_torch.client.operation import _RawHTTPConnection

        host, _, port = netloc.partition(":")
        return _RawHTTPConnection(host, int(port or 80), timeout), False

    def checkin(self, netloc: str, conn) -> None:
        with self._lock:
            idle = self._idle.setdefault(netloc, [])
            if len(idle) < self._PER_HOST:
                idle.append(conn)
                return
        conn.close()


_POOL = _ConnPool()


class _AttemptPool:
    """Reusable attempt workers: submit() hands the task to a parked
    idle worker when one exists, else starts a new thread that runs the
    task and then PARKS (up to `_MAX_IDLE`; beyond that it exits). A
    task never queues behind a busy worker — the fresh-thread fallback
    keeps the fire latency of a new thread while the steady state
    recycles the same few threads.

    Unlike the reference's pool, a worker drops its task (and the
    closure's captures: an EcVolume, staging buffers) before it parks,
    and close_idle() ends the parked workers at once: a volume server's
    stop() calls it, so no attempt worker outlives the servers that
    used it."""

    _MAX_IDLE = 8
    _IDLE_S = 30.0

    def __init__(self) -> None:
        self._lock = threading.Lock()
        self._idle: list[queue.SimpleQueue] = []
        self._threads: dict[queue.SimpleQueue, threading.Thread] = {}
        self.spawned = 0  # lifetime thread count (leak-baseline tests)

    def submit(self, fn, *args) -> None:
        with self._lock:
            q = self._idle.pop() if self._idle else None
        if q is not None:
            q.put((fn, args))
            return
        q = queue.SimpleQueue()
        q.put((fn, args))
        t = threading.Thread(
            target=self._worker, args=(q,), daemon=True,
            name="weed-hedge-worker",
        )
        with self._lock:
            self.spawned += 1
            self._threads[q] = t
        t.start()

    def _worker(self, q: "queue.SimpleQueue") -> None:
        try:
            while True:
                try:
                    task = q.get(timeout=self._IDLE_S)
                except queue.Empty:
                    with self._lock:
                        if q in self._idle:
                            self._idle.remove(q)
                            return
                    # a submitter claimed this queue between the timeout
                    # and the lock: its task is (or is about to be) queued
                    task = q.get()
                if task is None:  # close_idle()
                    return
                try:
                    task[0](*task[1])
                except BaseException:  # noqa: BLE001 — attempts report via out_q
                    pass
                del task  # nothing of the task stays alive while parked
                with self._lock:
                    if len(self._idle) >= self._MAX_IDLE:
                        return
                    self._idle.append(q)
        finally:
            with self._lock:
                self._threads.pop(q, None)

    def close_idle(self, timeout: float = 10.0) -> None:
        """End every parked worker and wait for it. Busy workers finish
        their task first and then park or exit as usual; a later
        submit() starts a fresh worker."""
        with self._lock:
            idle, self._idle = self._idle, []
            threads = [self._threads.get(q) for q in idle]
        for q in idle:
            q.put(None)
        for t in threads:
            if t is not None:
                t.join(timeout)


_ATTEMPTS = _AttemptPool()


def close_idle() -> None:
    """End the shared pool's parked attempt workers (_AttemptPool.close_idle)."""
    _ATTEMPTS.close_idle()


def submit_attempt(fn, *args) -> None:
    """Run `fn(*args)` on the shared cached attempt-worker pool (the
    same parked threads hedged GETs fire on). Fire-and-forget: results
    travel through whatever channel `fn` closes over."""
    _ATTEMPTS.submit(fn, *args)


def gather_first_k(tasks: dict, k: int, timeout: float = 30.0) -> dict:
    """Fan every task out on the shared attempt pool; return the first
    `k` successes as {tag: result}. The k-of-n gather the EC degraded
    read path runs over shard survivors: all candidates race, the k
    fastest win, the rest are abandoned.

    `tasks` maps tag -> callable(done_event) -> result; returning None
    (or raising) is a miss. `done_event` is set once k results are in —
    a long task can consult it between retries to stop doing abandoned
    work (attempt-level cancellation; the pool worker itself is
    recycled either way)."""
    if k <= 0 or not tasks:
        return {}
    done = threading.Event()
    out_q: queue.Queue = queue.Queue()

    def run(tag, fn):
        result = None
        try:
            result = fn(done)
        except Exception:  # noqa: BLE001 — a failed attempt is a miss
            result = None
        out_q.put((tag, result))

    for tag, fn in tasks.items():
        _ATTEMPTS.submit(run, tag, fn)

    got: dict = {}
    pending = len(tasks)
    deadline = time.monotonic() + timeout
    while len(got) < k and pending > 0:
        wait = deadline - time.monotonic()
        if wait <= 0:
            break
        try:
            tag, result = out_q.get(timeout=wait)
        except queue.Empty:
            break
        pending -= 1
        if result is not None:
            got[tag] = result
    done.set()
    return got


class _Attempt:
    """One in-flight GET try. cancel() is safe against the completion
    race: the owning thread marks `finished` under the same lock before
    returning its connection to the pool, so cancel can never close a
    connection that has been (or could be) handed to someone else."""

    __slots__ = ("tag", "url", "lock", "conn", "netloc", "finished",
                 "cancelled")

    def __init__(self, tag: int, url: str):
        self.tag = tag
        self.url = url
        self.lock = threading.Lock()
        self.conn = None
        self.netloc = url.partition("/")[0]
        self.finished = False
        self.cancelled = False

    def cancel(self) -> bool:
        """Tear down the in-flight attempt; True if it was still live
        (the socket close is what stops the server-side work)."""
        with self.lock:
            if self.finished or self.cancelled:
                return False
            self.cancelled = True
            if self.conn is not None:
                self.conn.close()
            return True

    def run(self, headers: dict, timeout: float, out_q: "queue.Queue") -> None:
        try:
            conn, reused = _POOL.checkout(self.netloc, timeout)
        except OSError as e:
            out_q.put((self.tag, e, 0, None, None))
            return
        with self.lock:
            if self.cancelled:
                conn.close()
                out_q.put((self.tag, OSError("hedge attempt cancelled"),
                           0, None, None))
                return
            self.conn = conn
        path = "/" + self.url.partition("/")[2]
        try:
            conn.send_request("GET", path, None, headers)
            status, rheaders, body, will_close = conn.read_response("GET")
        except (OSError, http.client.HTTPException) as e:
            conn.close()
            cancelled_now = self.cancelled
            if not reused or cancelled_now:
                out_q.put((self.tag, e, 0, None, None))
                return
            # a stale pooled connection gets ONE fresh-dial retry (GET
            # is idempotent), mirroring op.http_call's retry contract
            from seaweedfs_tpu_torch.client.operation import _RawHTTPConnection

            host, _, port = self.netloc.partition(":")
            try:
                conn = _RawHTTPConnection(host, int(port or 80), timeout)
            except OSError as e2:
                out_q.put((self.tag, e2, 0, None, None))
                return
            with self.lock:
                if self.cancelled:
                    conn.close()
                    out_q.put((self.tag, e, 0, None, None))
                    return
                self.conn = conn
            try:
                conn.send_request("GET", path, None, headers)
                status, rheaders, body, will_close = conn.read_response("GET")
            except (OSError, http.client.HTTPException) as e2:
                conn.close()
                out_q.put((self.tag, e2, 0, None, None))
                return
        with self.lock:
            if self.cancelled:
                conn.close()
                out_q.put((self.tag, OSError("hedge attempt cancelled"),
                           0, None, None))
                return
            self.finished = True
        if will_close:
            conn.close()
        else:
            _POOL.checkin(self.netloc, conn)
        out_q.put((self.tag, None, status, rheaders, body))


TRACKER = LatencyTracker()


def download(
    urls: list[str],
    key=None,
    timeout: float = 30.0,
    stats: dict | None = None,
    eager: bool = False,
) -> tuple[bytes, dict]:
    """GET `urls[0]`, hedging to `urls[1]` after the adaptive delay.

    `urls` are scheme-less "host:port/fid" replica targets (healthiest
    first — callers order them through the vid_map circuit breaker).
    `key` buckets the latency history (pass the volume id). `stats`, if
    given, collects {"fired","won","cancelled"} increments for callers
    that report their own counts (weedload workers). `eager` fires the
    hedge IMMEDIATELY instead of waiting the adaptive delay — the
    health plane's lever (docs/HEALTH.md) when the primary candidate
    is a master-flagged suspect: waiting a p95 against a gray node
    just donates the delay to the tail. Returns (body, headers) like
    client.operation.download; raises HTTPError on an error status and
    OSError when every replica fails."""
    from seaweedfs_tpu_torch.client import operation as op

    if len(urls) < 2 or not qos.enabled("hedge"):
        return op.download(urls[0], timeout=timeout)

    # deadline plane (docs/CHAOS.md): the hedge race runs on the SAME
    # clock as everything else — the driver's overall timeout shrinks
    # to the request's remaining budget (raising DeadlineExceeded when
    # none is left, before any attempt fires), and each attempt's
    # request carries the hop header so a server can fast-reject work
    # the caller already gave up on
    from seaweedfs_tpu_torch.util import deadline as _dl_mod

    dl = _dl_mod.effective(None)
    if dl is not None:
        timeout = dl.cap(timeout)
    if key is None:
        # fid "vid,..." → vid buckets the latency history
        tail = urls[0].partition("/")[2]
        key = tail.partition(",")[0]
    out_q: queue.Queue = queue.Queue()
    with trace.span("qos.hedge", plane="serve") as sp:
        base_headers: dict = {}
        trace.inject(base_headers)
        _dl_mod.stamp(base_headers, dl)
        primary = _Attempt(0, urls[0])
        attempts = [primary]
        _ATTEMPTS.submit(primary.run, base_headers, timeout, out_q)

        def fire_hedge():
            # the second (tied) attempt: hop header stamped, counted as
            # fired whether the trigger was the elapsed delay or an
            # outright primary failure (so won <= fired always holds)
            HEDGE_FIRED.inc()
            if stats is not None:
                stats["fired"] = stats.get("fired", 0) + 1
            sp.annotate("hedged", 1)
            h2 = dict(base_headers)
            h2[qos.HEDGE_HEADER] = "1"
            second = _Attempt(1, urls[1])
            attempts.append(second)
            _ATTEMPTS.submit(second.run, h2, timeout, out_q)

        delay = 0.0 if eager else TRACKER.delay_s(key)
        t0 = time.perf_counter()
        hedged = False
        deadline = t0 + timeout
        result = None  # (tag, status, headers, body)
        last_err: Exception | None = None
        saw_redirect = False
        while result is None:
            now = time.perf_counter()
            if now >= deadline:
                break
            if not hedged:
                wait = min(delay - (now - t0), deadline - now)
            else:
                wait = deadline - now
            if wait > 0:
                try:
                    tag, err, status, rheaders, body = out_q.get(timeout=wait)
                except queue.Empty:
                    if hedged:
                        break
                    tag = None
            else:
                tag = None
            if tag is None:
                if hedged:
                    continue
                # adaptive delay elapsed with no answer: fire the hedge
                hedged = True
                fire_hedge()
                continue
            if err is not None or status >= 300:
                if err is not None:
                    last_err = err
                    _vm.note_failure(attempts[tag].netloc)
                else:
                    last_err = urllib.error.HTTPError(
                        f"http://{attempts[tag].url}", status,
                        f"HTTP {status}", rheaders, io.BytesIO(body),
                    )
                    if 300 <= status < 400:
                        saw_redirect = True
                attempts[tag].finished = True
                if len(attempts) == 1:
                    # primary failed outright: go straight to replica 2
                    hedged = True
                    fire_hedge()
                elif all(a.finished or a.cancelled for a in attempts):
                    break
                continue
            result = (tag, status, rheaders, body)
        # cancel whichever attempt lost (or still runs on timeout)
        for a in attempts:
            if result is None or a.tag != result[0]:
                if a.cancel():
                    HEDGE_CANCELLED.inc()
                    if stats is not None:
                        stats["cancelled"] = stats.get("cancelled", 0) + 1
        if result is None:
            if saw_redirect:
                # volume read-redirect (a `-readRedirect` server 302s
                # when its location map says the volume moved): the
                # hedge driver doesn't chase redirects across attempt
                # threads — if ANY replica pointed elsewhere (not just
                # the last to answer; a stale peer's 404 may land
                # after the 302), hand the read to the pooled
                # single-attempt path, which follows redirects like
                # the pre-hedge code did
                return op.download(urls[0], timeout=timeout)
            raise last_err if last_err is not None else OSError(
                f"hedged read of {urls[0]} timed out"
            )
        tag, status, rheaders, body = result
        if tag == 1:
            HEDGE_WON.inc()
            if stats is not None:
                stats["won"] = stats.get("won", 0) + 1
            sp.annotate("hedge_won", 1)
        _vm.note_success(attempts[tag].netloc)
        # adaptive-delay feedback. A hedged completion is a CENSORED
        # observation: the primary was abandoned at `delay`, so the
        # winner's total (≈ delay + hedge RTT) says nothing about the
        # un-truncated service-time distribution — recording it raw
        # ratchets the p95 upward by one hedge RTT per hedge (each new
        # delay re-truncates the distribution just above itself).
        # Record hedged wins AT the censoring point and unhedged
        # completions at their true latency: the quantile then tracks
        # the volume's real service tail and the delay has a fixpoint.
        sample = time.perf_counter() - t0
        if not eager:
            # eager races (suspect primary) say nothing about the
            # volume's normal service tail — recording their min(·, 0)
            # would poison the ring with zeros
            TRACKER.record(key, min(sample, delay) if hedged else sample)
        return body, rheaders
