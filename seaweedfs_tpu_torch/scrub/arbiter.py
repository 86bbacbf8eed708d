"""BandwidthArbiter: ONE budget for every background byte-mover.

Four claimants share the node's background bandwidth — EC rebuilds
("rebuild"), cross-cluster replication ("replication"), hinted-handoff
replay ("handoff"), and lifecycle tiering ("tier"). Without it each
runs unpaced: a big handoff spool replayed at full speed against a
rebuild racing a second shard loss (the known gap ROADMAP names), and
tier/replication would have joined the stampede. Now every one of them
charges its bytes here BEFORE moving them.

Mechanics (docs/TIERING.md):

  * weighted max-min shares: each claimant owns a token bucket whose
    rate is its weight's slice of the total — but only ACTIVE
    claimants (charged within the last 2 s) count in the denominator,
    so a lone claimant gets the whole budget and shares shrink only
    under real contention. That is what makes the handoff-vs-rebuild
    regression hold: a 100-hint replay storm drops to its weighted
    slice the moment a rebuild starts charging.
  * serve-first yield (the PR-12 rebuild arbitration idiom): the
    serving path stamps note_serve() on every foreground GET/POST;
    while a stamp is fresher than the yield window, every background
    rate is multiplied down by the yield factor — foreground latency
    outranks all four claimants.
  * debt semantics match scrub/ratelimit.TokenBucket: admission waits
    on min(n, burst), the charge is the full n, so oversized items
    (a 4 MiB shard tile) keep the long-run rate exact without
    deadlocking.

`WEED_ARBITER=0` disables pacing wholesale (every take returns
immediately; stats still count). `WEED_ARBITER_MBPS` sets the total
budget (default 256 MB/s), `WEED_ARBITER_YIELD_MS` /
`WEED_ARBITER_YIELD_FACTOR` tune the serve-first yield.
"""

from __future__ import annotations

import os
import threading
import time

# weighted shares under full contention; rebuilds outrank everything
# (they are the redundancy clock), tier is the most patient
DEFAULT_WEIGHTS = {
    "rebuild": 0.45,
    "replication": 0.25,
    "handoff": 0.20,
    "tier": 0.10,
}

_ACTIVE_WINDOW_S = 2.0


def arbiter_enabled() -> bool:
    return os.environ.get("WEED_ARBITER", "1") != "0"


def _float(raw: str | None, default: float) -> float:
    # callers pass os.environ.get("WEED_...") inline so the weedlint
    # contract-env rule can see which knob each read belongs to
    try:
        return float(raw or default)
    except ValueError:
        return default


class _Claim:
    __slots__ = ("tokens", "last", "last_active", "bytes", "waited_s", "takes")

    def __init__(self, now: float):
        self.tokens = 0.0
        self.last = now
        self.last_active = 0.0  # never active until the first take
        self.bytes = 0
        self.waited_s = 0.0
        self.takes = 0


class BandwidthArbiter:
    def __init__(
        self,
        total_bytes_s: float | None = None,
        weights: dict[str, float] | None = None,
        yield_window_s: float | None = None,
        yield_factor: float | None = None,
    ):
        if total_bytes_s is None:
            total_bytes_s = (
                _float(os.environ.get("WEED_ARBITER_MBPS"), 256.0) * 1e6
            )
        self.total = float(total_bytes_s)
        self.weights = dict(weights or DEFAULT_WEIGHTS)
        self.yield_window_s = (
            _float(os.environ.get("WEED_ARBITER_YIELD_MS"), 200.0) / 1000.0
            if yield_window_s is None
            else yield_window_s
        )
        self.yield_factor = (
            _float(os.environ.get("WEED_ARBITER_YIELD_FACTOR"), 0.25)
            if yield_factor is None
            else yield_factor
        )
        now = time.monotonic()
        self._claims = {name: _Claim(now) for name in self.weights}
        self._last_serve = 0.0
        self._lock = threading.Lock()
        self.enabled = arbiter_enabled() and self.total > 0

    # --- serve-first yield -------------------------------------------------
    def note_serve(self) -> None:
        """Stamp foreground traffic; lock-free (a torn float store does
        not exist in CPython, and staleness of one GET is harmless)."""
        self._last_serve = time.monotonic()

    def _rate_locked(self, name: str, now: float) -> float:
        active_weight = 0.0
        for n, c in self._claims.items():
            if n == name or now - c.last_active < _ACTIVE_WINDOW_S:
                active_weight += self.weights.get(n, 0.1)
        share = self.weights.get(name, 0.1) / max(active_weight, 1e-9)
        rate = self.total * share
        if now - self._last_serve < self.yield_window_s:
            rate *= self.yield_factor
        return max(rate, 1.0)

    # --- the charge point --------------------------------------------------
    def take(self, name: str, n: int, stop: threading.Event | None = None) -> bool:
        """Charge `n` background bytes to claimant `name`, blocking
        until the claimant's current share admits them. Returns False
        (without consuming) when `stop` fires first."""
        from seaweedfs_tpu_torch.stats.metrics import ARBITER_BYTES, ARBITER_WAIT_SECONDS

        with self._lock:
            claim = self._claims.get(name)
            if claim is None:
                claim = self._claims[name] = _Claim(time.monotonic())
            claim.takes += 1
            claim.bytes += int(n)
        ARBITER_BYTES.labels(name).inc(int(n))
        if not self.enabled:
            return True
        started = time.monotonic()
        while True:
            with self._lock:
                now = time.monotonic()
                rate = self._rate_locked(name, now)
                burst = max(rate, 1.0)  # one second of the current share
                claim.tokens = min(
                    burst, claim.tokens + (now - claim.last) * rate
                )
                claim.last = now
                claim.last_active = now
                need = min(float(n), burst)
                if claim.tokens >= need:
                    claim.tokens -= float(n)
                    waited = now - started
                    claim.waited_s += waited
                    if waited > 0:
                        ARBITER_WAIT_SECONDS.labels(name).inc(waited)
                    return True
                wait = (need - claim.tokens) / rate
            wait = min(wait, 0.25)
            if stop is not None:
                if stop.wait(wait):
                    with self._lock:
                        claim.bytes -= int(n)  # never moved
                    return False
            else:
                time.sleep(wait)

    # --- observability -----------------------------------------------------
    def stats(self) -> dict:
        with self._lock:
            now = time.monotonic()
            return {
                "Enabled": self.enabled,
                "TotalBytesPerSec": self.total,
                "YieldWindowMs": round(self.yield_window_s * 1000, 1),
                "YieldFactor": self.yield_factor,
                "Serving": now - self._last_serve < self.yield_window_s,
                "Claimants": {
                    name: {
                        "Weight": self.weights.get(name, 0.1),
                        "Bytes": c.bytes,
                        "Takes": c.takes,
                        "WaitedSeconds": round(c.waited_s, 3),
                        "Active": now - c.last_active < _ACTIVE_WINDOW_S,
                        "RateBytesPerSec": round(self._rate_locked(name, now)),
                    }
                    for name, c in self._claims.items()
                },
            }


# --- process-global instance ----------------------------------------------
# One arbiter per process: the RepairScheduler owns/constructs it on the
# master, but volume servers + filers (handoff replay, replication,
# tier transfers) reach it through this accessor so every claimant in a
# process shares ONE budget. Tests swap it with set_arbiter().
_arbiter: BandwidthArbiter | None = None
_arbiter_lock = threading.Lock()


def get_arbiter() -> BandwidthArbiter:
    global _arbiter
    with _arbiter_lock:
        if _arbiter is None:
            _arbiter = BandwidthArbiter()
        return _arbiter


def set_arbiter(a: BandwidthArbiter | None) -> BandwidthArbiter | None:
    """Install (or with None, reset) the process arbiter; returns the
    previous one so tests can restore it."""
    global _arbiter
    with _arbiter_lock:
        prev, _arbiter = _arbiter, a
        return prev
