"""End-to-end request deadlines (docs/CHAOS.md).

One per-request clock that every hop shares. A request's total budget
is minted once — at the client that cares, or at the first gateway a
budget-less request enters — and rides the `X-Weed-Deadline` hop
header as REMAINING milliseconds, re-stamped at each hop (remaining
budget, not an absolute timestamp: cluster nodes share no clock, and
network transit only ever shrinks the budget, which errs safe).

Consumers:
  * `client/operation.http_call` derives every socket operation's
    timeout from the remaining budget, so a server trickling one byte
    per 29 s can no longer outlive the caller's intent (the per-op
    `timeout=` used to reset on every recv);
  * `pb/rpc.Stub` does the same for gRPC attempts and forwards the
    budget as invocation metadata;
  * the mini request loop (util/httpd.serve_connection) parses the
    header at every daemon, 504-fast-rejects already-expired requests
    BEFORE dispatch (no disk touched, no downstream fan-out), and
    installs the deadline as the ambient one so internal hops the
    handler makes inherit it automatically;
  * hedged reads and the unified RetryPolicy (client/retry.py)
    check the same clock before spending work a caller will never see.

`WEED_DEADLINE=0` kills the plane wholesale (no stamping, no
derivation, no 504 fast-reject). `WEED_DEADLINE_DEFAULT_S` makes every
gateway ENTRY mint a budget for requests that arrive without one
(0/unset = only explicit deadlines propagate).
"""

from __future__ import annotations

import os
import threading
import time

# hop header: remaining milliseconds at stamp time (float text).
# Stamped by client/operation.http_call + pb/rpc.Stub, parsed by
# util/httpd.serve_connection and pb/rpc.servicer_handler.
DEADLINE_HEADER = "x-weed-deadline"

# a budget can never exceed this (header values are untrusted input;
# an absurd value would otherwise pin a connection's socket timeout
# into next week)
MAX_BUDGET_S = 24 * 3600.0

# floor for derived socket timeouts: 0 would mean non-blocking, and a
# sub-millisecond recv window only ever measures scheduler noise
MIN_OP_TIMEOUT_S = 0.001


class DeadlineExceeded(TimeoutError):
    """The request's whole-request budget ran out (client side).

    A TimeoutError subclass on purpose: every existing transport
    handler that treats a socket timeout as 'this attempt failed,
    do not blindly replay' applies verbatim to an exhausted budget."""


def enabled() -> bool:
    """Plane kill switch, read per call like the QoS switches so a
    test or an operator restart can flip it without import-order
    games."""
    return os.environ.get("WEED_DEADLINE", "1") != "0"


def default_budget_s() -> float:
    """Gateway-entry default budget (seconds); 0 = mint nothing."""
    try:
        return float(os.environ.get("WEED_DEADLINE_DEFAULT_S", "0") or 0)
    except ValueError:
        return 0.0


class Deadline:
    """An absolute point on the LOCAL monotonic clock."""

    __slots__ = ("at",)

    def __init__(self, at: float):
        self.at = at

    @classmethod
    def after(cls, seconds: float) -> "Deadline":
        return cls(time.monotonic() + min(seconds, MAX_BUDGET_S))

    def remaining(self) -> float:
        return self.at - time.monotonic()

    @property
    def expired(self) -> bool:
        return self.at - time.monotonic() <= 0

    def cap(self, timeout: float | None) -> float:
        """Per-attempt/socket-op timeout derived from the remaining
        budget: min(timeout, remaining), floored so it stays a valid
        blocking timeout. Raises DeadlineExceeded when nothing
        remains — callers must not start work the budget can't pay
        for."""
        rem = self.at - time.monotonic()
        if rem <= 0:
            raise DeadlineExceeded(
                f"deadline exceeded ({rem * 1000.0:.0f} ms over budget)"
            )
        if timeout is None or timeout <= 0:
            return max(rem, MIN_OP_TIMEOUT_S)
        return max(min(timeout, rem), MIN_OP_TIMEOUT_S)

    def header_value(self) -> str:
        """Remaining budget as the on-wire millisecond text (may be
        negative: an expired deadline still propagates so the receiver
        can account the rejection)."""
        return "%.1f" % ((self.at - time.monotonic()) * 1000.0)

    def __repr__(self) -> str:  # debugging/test output only
        return f"Deadline(remaining={self.remaining() * 1000.0:.1f}ms)"


def from_header(value: str) -> Deadline | None:
    """Parse an `X-Weed-Deadline` header value (remaining ms).

    Garbage → None (an unparseable budget must not 504 a request that
    never asked for one); negative values parse to an already-expired
    Deadline — that is the fast-reject contract."""
    try:
        ms = float(value)
    except (TypeError, ValueError):
        return None
    return Deadline(time.monotonic() + min(ms / 1000.0, MAX_BUDGET_S))


def from_grpc_context(context) -> Deadline | None:
    """Deadline carried as gRPC invocation metadata, if any."""
    try:
        md = context.invocation_metadata()
    except Exception:  # noqa: BLE001 - a test double without metadata
        return None
    if md:
        for k, v in md:
            if k == DEADLINE_HEADER:
                return from_header(v)
    return None


# ---------------------------------------------------------------------------
# ambient (per-thread) deadline — the serving funnel installs the
# request's deadline here so every internal hop the handler makes
# (http_call, gRPC Stub, hedged reads) inherits it without threading a
# parameter through dozens of call sites. Mirrors trace's thread-cell
# pattern: one attribute read on the hot path.

_tls = threading.local()


def current() -> Deadline | None:
    return getattr(_tls, "deadline", None)


def set_current(dl: Deadline | None) -> None:
    _tls.deadline = dl


class scope:
    """`with scope(dl):` — install `dl` as the ambient deadline for the
    block, restoring the previous one on exit (internal hops nest:
    a narrower explicit deadline inside a request must not clobber the
    request's own on the way out)."""

    __slots__ = ("_dl", "_prev")

    def __init__(self, dl: Deadline | None):
        self._dl = dl

    def __enter__(self):
        self._prev = getattr(_tls, "deadline", None)
        _tls.deadline = self._dl
        return self._dl

    def __exit__(self, *exc):
        _tls.deadline = self._prev
        return False


def effective(explicit: "Deadline | None" = None) -> Deadline | None:
    """The deadline governing an outbound hop: an explicit one wins,
    else the ambient request deadline, else None. Returns None
    wholesale when the plane is disabled."""
    if not enabled():
        return None
    return explicit if explicit is not None else current()


def stamp(headers: dict, dl: Deadline | None = None) -> None:
    """Write the hop header from `dl` (default: the effective
    deadline); no-op when there is none."""
    dl = effective(dl)
    if dl is not None:
        headers[DEADLINE_HEADER] = dl.header_value()
