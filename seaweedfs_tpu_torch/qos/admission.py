"""Per-client admission control at the serving edge (docs/QOS.md).

A token bucket per client key (S3 access key when the request carries
one, else the remote address) plus a process-wide in-flight cap. Over
budget → shed with 503 + Retry-After and the
weed_admission_rejected_total counter: backpressure instead of
collapse, and the client's `op.http_call` honors the Retry-After with
jitter so well-behaved tenants converge on their fair share.

The check runs inside the mini request loop's dispatch funnel
(util/httpd.serve_connection) — the one place every serving daemon's
requests pass through, including connections the C epoll loop hands
off — so shed requests still get spans, status-labelled request
counters, and correct keep-alive accounting for free.

`-serveProcs` process groups: with `shm_path` set, every sibling
charges ONE shared-memory GCRA bucket per client key (mmap'd file,
lock-free CAS — csrc/serve.c weed_shm_admit), so the GLOBAL rate
holds under arbitrarily skewed connection spread, and the C epoll
loop sheds over-budget requests without leaving C. Without it, each
sibling runs its own controller at rate/N — exact only when the
kernel spreads connections uniformly across SO_REUSEPORT listeners.
"""

from __future__ import annotations

import threading
import time

from seaweedfs_tpu_torch import qos
from seaweedfs_tpu_torch.stats.metrics import ADMISSION_REJECTED

_MAX_BUCKETS = 4096


def client_key(handler) -> str:
    """The admission identity of one request: the S3 access key when an
    Authorization header carries one (AWS4-HMAC-SHA256 Credential=KEY/…
    or the legacy `AWS KEY:sig`), else the remote address."""
    auth = handler.headers.get("authorization", "") if handler.headers else ""
    if auth:
        if auth.startswith("AWS4-HMAC-SHA256"):
            idx = auth.find("Credential=")
            if idx >= 0:
                cred = auth[idx + len("Credential="):]
                return cred.split("/", 1)[0].strip()
        elif auth.startswith("AWS "):
            return auth[4:].split(":", 1)[0].strip()
    addr = getattr(handler, "client_address", None)
    return addr[0] if addr else "unknown"


class AdmissionController:
    """admit(key) → None (admitted) or a Retry-After float (shed)."""

    def __init__(
        self,
        rate: float,
        burst: float = 0.0,
        max_inflight: int = 0,
        procs: int = 1,
        label: str = "server",
        retry_after_s: float = 1.0,
        shm_path: str = "",
    ):
        procs = max(1, procs)
        # shared-bucket mode: every `-serveProcs`/`-workers`
        # sibling charges ONE mmap'd GCRA bucket per client key, so the
        # GLOBAL rate holds even when the kernel parks every connection
        # on one listener. No rate/N split; the in-flight cap stays
        # process-local (queue length is a per-process resource). The
        # C epoll loop enforces the same bucket natively when it serves
        # a request without handing off. A bucket that cannot be
        # attached raises: a quiet per-process split would let the
        # group admit N times the configured rate.
        self.shared = False
        self.shm_path = shm_path
        if shm_path and rate > 0:
            from seaweedfs_tpu_torch.util import native_serve

            self.shared = native_serve.admission_shm_attach(
                shm_path,
                rate,
                max(rate, burst or 2.0 * rate),
                retry_after_s,
            )
        if self.shared:
            self.rate = rate
            self.burst = max(rate, burst or 2.0 * rate)
        else:
            # per-process share of the GLOBAL per-client budget
            self.rate = rate / procs
            self.burst = max(self.rate, (burst or 2.0 * rate) / procs)
        self.max_inflight = max_inflight
        self.label = label
        self.retry_after_s = retry_after_s
        self._lock = threading.Lock()
        self._buckets: dict[str, tuple[float, float]] = {}  # key -> (tokens, ts)
        self._inflight = 0
        self.rejected = 0  # process-local count (operator surfaces)

    # ------------------------------------------------------------------
    def admit(self, key: str, now: float | None = None) -> float | None:
        """Charge one token against `key`'s bucket; returns None when
        admitted, else the seconds the client should wait (Retry-After).
        The in-flight cap sheds regardless of key — queue length is a
        process-wide resource."""
        return self._admit_enter(key, now=now, enter=False)[0]

    def _admit_enter(
        self, key: str, now: float | None = None, enter: bool = True
    ) -> tuple[float | None, bool]:
        """(retry_after | None, entered). With `enter`, an admitted
        request is counted into the in-flight total INSIDE the same
        lock hold as the cap check — a separate check-then-increment
        window would let a simultaneous burst of N threads all pass a
        cap of 2 before any of them counted. `entered` tells the caller
        whether an _exit() is owed: the env kill switches are read per
        call, so a flip mid-request must not make the finally-side
        decrement underflow the counter (and silently widen the cap)."""
        if not qos.enabled("admission"):
            return None, False
        now = now if now is not None else time.monotonic()
        with self._lock:
            if self.max_inflight and self._inflight >= self.max_inflight:
                self.rejected += 1
                ADMISSION_REJECTED.labels(self.label).inc()
                return self.retry_after_s, False
            if self.shared:
                from seaweedfs_tpu_torch.util import native_serve

                # one CAS against the mmap'd bucket all siblings share;
                # the retry value already carries the retry_after floor
                retry = native_serve.admission_shm_admit(key)
                if retry > 0.0:
                    self.rejected += 1
                    ADMISSION_REJECTED.labels(self.label).inc()
                    return retry, False
            elif self.rate > 0:
                tokens, ts = self._buckets.get(key, (self.burst, now))
                tokens = min(self.burst, tokens + (now - ts) * self.rate)
                if tokens < 1.0:
                    self._buckets[key] = (tokens, now)
                    self.rejected += 1
                    ADMISSION_REJECTED.labels(self.label).inc()
                    # time until one whole token refills
                    return (
                        max(self.retry_after_s, (1.0 - tokens) / self.rate),
                        False,
                    )
                self._buckets[key] = (tokens - 1.0, now)
                if len(self._buckets) > _MAX_BUCKETS:
                    self._evict(now)
            if enter:
                self._inflight += 1
        return None, enter

    def _exit(self) -> None:
        with self._lock:
            self._inflight -= 1

    def _evict(self, now: float) -> None:
        # drop the stalest half by last-touch; called under the lock
        items = sorted(self._buckets.items(), key=lambda kv: kv[1][1])
        for k, _ in items[: len(items) // 2]:
            del self._buckets[k]

    # ------------------------------------------------------------------
    # dispatch gate: serve_connection wraps the routed do_* method with
    # this so shed requests reply through the SAME traced/metered path
    def gate(self, method, handler):
        retry, entered = self._admit_enter(client_key(handler))
        if retry is None:
            try:
                return method(handler)
            finally:
                if entered:
                    self._exit()
        return self._shed(handler, retry)

    def _shed(self, handler, retry: float) -> None:
        handler.fast_reply(
            503,
            b'{"error": "admission control: over per-client budget"}',
            {
                "Content-Type": "application/json",
                "Retry-After": f"{retry:.3f}",
            },
        )

    def inflight(self) -> int:
        with self._lock:
            return self._inflight

    def status(self) -> dict:
        with self._lock:
            return {
                "RatePerProc": self.rate,
                "BurstPerProc": self.burst,
                "MaxInflight": self.max_inflight,
                "Inflight": self._inflight,
                "Clients": len(self._buckets),
                "Rejected": self.rejected,
                "Shared": self.shared,
                "ShmPath": self.shm_path if self.shared else "",
            }
