"""The process-wide retry budget (docs/CHAOS.md): the part of
seaweedfs_tpu/client/retry.py that the port's `http_call` uses. The
unified `RetryPolicy` comes with the master client (ROADMAP item 10);
until then nothing marks an attempt as a retry, so `in_retry()` is
False and every `http_call` credits the budget.

`RetryBudget` is a process-wide token bucket CREDITED by first-attempt
requests and DEBITED by retries, capping retries at ~10% of recent
first-attempt volume (`WEED_RETRY_BUDGET_RATIO`; 0 disables the gate).
When the cluster is healthy the budget is a no-op; when a dependency
blackholes, the budget empties after the first wave and every later
failure degrades to a plain error instead of multiplying upstream load.
A probe retry every couple of seconds keeps flowing even when dry, so
recovery is noticed (the gRPC/Finagle "retry budget" design).
"""

from __future__ import annotations

import os
import threading
import time

from seaweedfs_tpu_torch.stats.metrics import RETRY_BUDGET_EXHAUSTED


def _budget_ratio_default() -> float:
    try:
        return float(os.environ.get("WEED_RETRY_BUDGET_RATIO", "0.1"))
    except ValueError:
        return 0.1


# first-attempt vs retry marker: RetryPolicy.run sets this around
# retried attempts so the TRANSPORT (http_call) can credit the shared
# budget for first-attempt traffic only — retried requests crediting
# themselves is exactly the feedback loop the budget exists to cut
_tls = threading.local()


def in_retry() -> bool:
    return getattr(_tls, "in_retry", False)


class RetryBudget:
    """Process-wide retries-as-a-fraction-of-requests token bucket."""

    def __init__(
        self,
        ratio: float | None = None,
        min_reserve: float = 3.0,
        # burst ceiling: tokens banked during healthy traffic that a
        # fresh fault may spend at once. Kept SMALL on purpose — a
        # large bank lets the first seconds of an outage retry-storm
        # on saved credit and blows the ≤1.15× amplification bound the
        # chaos bench enforces; refill is continuous (ratio × request
        # rate), so sustained retry capacity is unaffected
        max_tokens: float = 16.0,
    ):
        # ratio None = read the env knob PER SPEND, so tests and
        # operators can retune a live process
        self._ratio = ratio
        self.min_reserve = min_reserve
        self.max_tokens = max_tokens
        self._lock = threading.Lock()
        self._tokens = min_reserve
        self._last_probe = 0.0
        self.spent = 0  # lifetime retries granted (operator surface)
        self.denied = 0  # lifetime retries refused

    def ratio(self) -> float:
        return self._ratio if self._ratio is not None else _budget_ratio_default()

    def note_request(self, n: int = 1) -> None:
        """Credit the budget for `n` first-attempt requests."""
        r = self.ratio()
        if r <= 0:
            return
        with self._lock:
            self._tokens = min(self.max_tokens, self._tokens + r * n)

    # dry-bucket probe cadence: frequent enough to notice a dependency
    # recovering, rare enough that probes stay noise against any real
    # request rate (the ≤1.15× amplification bound counts them too)
    probe_interval_s: float = 2.0

    def try_spend(self, now: float | None = None, cost: float = 1.0) -> bool:
        """Take `cost` retry tokens (cost ≈ the number of upstream
        requests this retry will reissue, so the ratio stays a bound on
        retried REQUEST volume, not on coarse-grained operations). When
        the bucket is dry, a probe retry is still granted once per
        probe interval — the budget throttles storms, it must not blind
        the process to the dependency recovering."""
        r = self.ratio()
        if r <= 0:
            return True
        now = now if now is not None else time.monotonic()
        with self._lock:
            if self._tokens >= cost:
                self._tokens -= cost
                self.spent += 1
                return True
            if now - self._last_probe >= self.probe_interval_s:
                self._last_probe = now
                self.spent += 1
                return True
            self.denied += 1
        RETRY_BUDGET_EXHAUSTED.inc()
        return False

    def status(self) -> dict:
        with self._lock:
            return {
                "Tokens": round(self._tokens, 3),
                "Ratio": self.ratio(),
                "Spent": self.spent,
                "Denied": self.denied,
            }


# the process-wide budget every retry site shares: the whole point is
# that ALL retry sites drain one pool, so a blackholed replica can't
# multiply load just by being hit from many call sites
DEFAULT_BUDGET = RetryBudget()
