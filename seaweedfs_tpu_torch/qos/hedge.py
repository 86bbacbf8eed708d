"""First-k-wins gathers on a shared pool of attempt workers: the part of
seaweedfs_tpu/qos/hedge.py that the EC degraded read uses
(`gather_first_k` and the pool of attempt workers behind it). The
hedged replica GETs of the reference need the HTTP client and are not
part of the port.
"""

from __future__ import annotations

import queue
import threading
import time


class _AttemptPool:
    """Reusable attempt workers: submit() hands the task to a parked
    idle worker when one exists, else starts a new thread that runs the
    task and then PARKS (up to `_MAX_IDLE`; beyond that it exits). A
    task never queues behind a busy worker — the fresh-thread fallback
    keeps the fire latency of a new thread while the steady state
    recycles the same few threads."""

    _MAX_IDLE = 8
    _IDLE_S = 30.0

    def __init__(self) -> None:
        self._lock = threading.Lock()
        self._idle: list[queue.SimpleQueue] = []
        self.spawned = 0  # lifetime thread count (leak-baseline tests)

    def submit(self, fn, *args) -> None:
        with self._lock:
            q = self._idle.pop() if self._idle else None
        if q is not None:
            q.put((fn, args))
            return
        q = queue.SimpleQueue()
        q.put((fn, args))
        with self._lock:
            self.spawned += 1
        threading.Thread(
            target=self._worker, args=(q,), daemon=True,
            name="weed-hedge-worker",
        ).start()

    def _worker(self, q: "queue.SimpleQueue") -> None:
        while True:
            try:
                fn, args = q.get(timeout=self._IDLE_S)
            except queue.Empty:
                with self._lock:
                    if q in self._idle:
                        self._idle.remove(q)
                        return
                # a submitter claimed this queue between the timeout
                # and the lock: its task is (or is about to be) queued
                fn, args = q.get()
            try:
                fn(*args)
            except BaseException:  # noqa: BLE001 — attempts report via out_q
                pass
            with self._lock:
                if len(self._idle) >= self._MAX_IDLE:
                    return
                self._idle.append(q)


_ATTEMPTS = _AttemptPool()


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
