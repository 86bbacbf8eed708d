"""weedguard: master-side node health scoring (docs/HEALTH.md), and the
volume server's disk watchdog. The port of seaweedfs_tpu/cluster/health.py.

The cluster's liveness model used to be binary — a node is alive while
its heartbeat stream is up (plus the node_timeout sweep), dead after.
The warehouse-cluster failure study (arXiv:1309.0186) and every
production postmortem about SIGSTOP'd/gray nodes say the interesting
failures live BETWEEN those states: a frozen process keeps its TCP
sessions open and stays in the write-assignment pool while every
request into it times out; a node with a dying disk serves EIO for
minutes before anything reacts.

This module scores every data node from three independent signal
families and drives a `healthy → suspect → dead` state machine with
hysteresis:

  * **phi-accrual suspicion** from heartbeat inter-arrival times
    (Hayashibara et al.): the master learns each node's own beat
    cadence and asks "how improbable is the current silence?" — a
    SIGSTOP'd node that never disconnects goes suspect within a few
    missed beats, long before the coarse node_timeout sweep;
  * **error EWMAs** fed from heartbeat-reported cumulative counters
    (EIO/ENOSPC seen serving, 5xx responses served) — a node that is
    reachable but failing work goes suspect too;
  * **operator/self-reported flags**: the volume server's local disk
    watchdog announces `lame_duck` (read-only after repeated IO
    errors), SIGTERM announces `draining`, and `node.drain` registers
    an operator drain master-side. These exclude the node from write
    assignment without demoting its reads.

Consumers (all master-side, so the whole cluster sees ONE verdict):
`pick_for_write` prefers volumes whose replicas are all assignable,
lookup responses order suspect replicas last and mark them
(`Location.suspect`) so clients demote them cluster-wide and the hedge
driver fires eagerly, and the RepairScheduler moves data off draining
nodes.

`WEED_HEALTH=0` kills the plane wholesale: every node reports healthy,
placement/serving revert to pre-health behavior, and replica-write
failures fail the write again (no hinted handoff). The port has no
hinted handoff yet (server/handoff.py, ROADMAP item 10): a replica's
failure always fails the write.
"""

from __future__ import annotations

import math
import os
import threading
import time

HEALTHY = "healthy"
SUSPECT = "suspect"
DEAD = "dead"


def enabled() -> bool:
    """Plane kill switch (WEED_HEALTH=0 restores pre-health behavior
    wholesale); read per call like the QoS switches so tests and
    operator restarts can flip it without import-order games."""
    return os.environ.get("WEED_HEALTH", "1") != "0"


def phi_threshold() -> float:
    """Suspicion threshold on the phi scale (WEED_HEALTH_PHI, default
    8 ≈ "this silence had a 10^-8 chance under the learned cadence").
    Lower = faster detection, more false suspects."""
    try:
        return float(os.environ.get("WEED_HEALTH_PHI", "8"))
    except ValueError:
        return 8.0


def err_ewma_threshold() -> float:
    """Errors-per-beat EWMA above which a node goes suspect
    (WEED_HEALTH_ERR_EWMA, default 3)."""
    try:
        return float(os.environ.get("WEED_HEALTH_ERR_EWMA", "3"))
    except ValueError:
        return 3.0


def recover_s() -> float:
    """Hysteresis hold-down (WEED_HEALTH_RECOVER_S, default 5):
    once suspect, a node must stay clean this long before it reads as
    healthy again — a gray node flapping across the phi threshold must
    not flap the assignment pool with it."""
    try:
        return float(os.environ.get("WEED_HEALTH_RECOVER_S", "5"))
    except ValueError:
        return 5.0


class PhiAccrual:
    """Phi-accrual failure detector over one node's heartbeat
    inter-arrival times (a ring of recent intervals; normal-tail
    approximation like Akka/Cassandra's detectors).

    phi(now) = -log10(P(interval > now - last_arrival)) under a normal
    fit of the observed intervals, with the std floored so a perfectly
    regular beat doesn't make the detector infinitely twitchy."""

    _RING = 32
    _MIN_SAMPLES = 3
    # floors: beats are scheduler-jittery at millisecond scale, and a
    # zero std would turn one late packet into phi=inf
    _MIN_STD_FRAC = 0.15
    _MIN_STD_S = 0.05
    # suspicion gate: silence only counts once it exceeds this multiple
    # of the WORST inter-arrival gap in the ring. Heartbeats are not a
    # pure tick — inventory changes fire forced delta beats in bursts
    # of near-zero intervals that drag the learned mean far below the
    # real cadence, and without the gate the next NORMAL tick read as
    # a phi spike (a healthy node flapping suspect right after
    # registering volumes — found by the SIGSTOP scenario, where the
    # flap emptied the clean assignment pool). Extra beats can only
    # make silence LESS alarming, never more.
    _GATE_FACTOR = 2.0
    # burst intervals below this never enter the ring: forced beats
    # land milliseconds apart and say nothing about the tick cadence —
    # a ring full of them (a node registering 7 volumes before its
    # first regular beat) would make the FIRST normal tick read as a
    # phi spike and defeat the gate above (max of a pure-burst ring is
    # itself tiny)
    _MIN_GAP_S = 0.02

    # a beat ENDING a silence the detector itself flagged suspicious is
    # an outage resume, not cadence — recording it would poison the
    # gate (max(intervals) jumps to the outage length, blinding the
    # NEXT gray failure for up to a full ring). But a permanently
    # skipped sample must not exist either — an operator restarting
    # with a 20× slower -heartbeat would read suspect forever — so
    # after this many consecutive skips the next interval is accepted
    # and the ring re-learns the new cadence.
    _MAX_SKIPS = 3

    __slots__ = ("_intervals", "_pos", "last_arrival", "_skipped")

    def __init__(self) -> None:
        self._intervals: list[float] = []
        self._pos = 0
        self.last_arrival = 0.0
        self._skipped = 0

    def observe(self, now: float) -> None:
        if self.last_arrival:
            iv = now - self.last_arrival
            suspicious = (
                self.phi(now) > phi_threshold()
                and self._skipped < self._MAX_SKIPS
            )
            if suspicious:
                self._skipped += 1
            elif iv >= self._MIN_GAP_S:
                self._skipped = 0
                if len(self._intervals) < self._RING:
                    self._intervals.append(iv)
                else:
                    self._intervals[self._pos] = iv
                    self._pos = (self._pos + 1) % self._RING
        self.last_arrival = now

    def warmed(self) -> bool:
        """Enough cadence history that silence CAN raise phi. Surfaced
        on /cluster/health so operators (and e2e rigs) can barrier on
        the detector being armed instead of sleeping a fixed number of
        beats — a wall-clock warm-up assumes the configured cadence,
        and on a loaded host the beat thread can run late enough that
        the sleep ends with fewer than _MIN_SAMPLES intervals in the
        ring, leaving phi pinned at 0."""
        return len(self._intervals) >= self._MIN_SAMPLES

    def gate_s(self) -> float:
        """The current suspicion gate in seconds: silence shorter than
        this reads as phi=0 (see _GATE_FACTOR). This is the LEARNED
        earliest-detection horizon — it tracks the worst observed
        inter-arrival gap, not the configured tick, so any promptness
        expectation (alert SLO, test bound) must be stated relative to
        it rather than to `-heartbeat`."""
        if not self._intervals:
            return 0.0
        return self._GATE_FACTOR * max(self._intervals)

    def phi(self, now: float) -> float:
        """0 while within the learned cadence; grows without bound as
        the silence stretches. 0 before enough history exists (a brand
        new node must not be born suspect)."""
        if not self.last_arrival or len(self._intervals) < self._MIN_SAMPLES:
            return 0.0
        elapsed = now - self.last_arrival
        if elapsed <= self._GATE_FACTOR * max(self._intervals):
            return 0.0
        n = len(self._intervals)
        mean = sum(self._intervals) / n
        var = sum((x - mean) ** 2 for x in self._intervals) / n
        std = max(math.sqrt(var), mean * self._MIN_STD_FRAC, self._MIN_STD_S)
        z = (elapsed - mean) / std
        if z <= 0:
            return 0.0
        # P(X > elapsed) for a normal tail; the log-survival form keeps
        # precision where the probability underflows a float
        p = 0.5 * math.erfc(z / math.sqrt(2.0))
        if p <= 0.0:
            # erfc underflow: asymptotic log10 tail, still monotone in z
            return (z * z) / (2.0 * math.log(10.0))
        return -math.log10(p)


class NodeHealth:
    """One node's live health record on the master."""

    __slots__ = (
        "url", "detector", "err_ewma", "_last_io_errors",
        "_last_request_errors", "lame_duck", "draining", "drain_requested",
        "scrub_flagged", "dead", "dead_since", "_suspect_until",
        "_last_reasons",
    )

    _EWMA_ALPHA = 0.3

    def __init__(self, url: str):
        self.url = url
        self.detector = PhiAccrual()
        self.err_ewma = 0.0
        self._last_io_errors = 0
        self._last_request_errors = 0
        self.lame_duck = False
        self.draining = False           # self-announced (SIGTERM drain)
        self.drain_requested = False    # operator-requested (node.drain)
        self.scrub_flagged = False
        self.dead = False
        self.dead_since = 0.0
        self._suspect_until = 0.0
        self._last_reasons: tuple[str, ...] = ()

    def observe(
        self,
        now: float,
        io_errors: int = 0,
        request_errors: int = 0,
        lame_duck: bool = False,
        draining: bool = False,
    ) -> None:
        self.detector.observe(now)
        # per-beat error delta: an EIO on the serving path bumps BOTH
        # counters (io_errors at the watchdog, request_errors from its
        # 500 reply), so summing would double-count disk errors and
        # trip the EWMA threshold at half the documented sensitivity —
        # max() gives the true count when they overlap and still
        # catches the disjoint cases (scrub-path EIOs produce no 500;
        # handler bugs 500 with no disk fault). Cumulative counters:
        # a restarted node resets to 0 — clamp so the reset never
        # reads as a negative burst.
        io_delta = max(0, io_errors - self._last_io_errors)
        req_delta = max(0, request_errors - self._last_request_errors)
        delta = max(io_delta, req_delta)
        self._last_io_errors = io_errors
        self._last_request_errors = request_errors
        a = self._EWMA_ALPHA
        self.err_ewma = a * delta + (1 - a) * self.err_ewma
        self.lame_duck = lame_duck
        self.draining = draining
        self.dead = False

    def suspicion_reasons(self, now: float) -> tuple[str, ...]:
        """Why this node is currently suspect; empty = clean signals."""
        reasons = []
        phi = self.detector.phi(now)
        if phi > phi_threshold():
            reasons.append("phi=%.1f" % phi)
        if self.err_ewma > err_ewma_threshold():
            reasons.append("err_ewma=%.1f" % self.err_ewma)
        if self.scrub_flagged:
            reasons.append("scrub")
        return tuple(reasons)

    def state(self, now: float | None = None) -> str:
        """healthy | suspect | dead, with hysteresis: suspicion holds
        for recover_s past the last bad signal so a flapping gray node
        doesn't flap the pool."""
        if not enabled():
            return DEAD if self.dead else HEALTHY
        if self.dead:
            return DEAD
        now = time.monotonic() if now is None else now
        reasons = self.suspicion_reasons(now)
        if reasons:
            self._last_reasons = reasons
            self._suspect_until = now + recover_s()
            return SUSPECT
        if now < self._suspect_until:
            return SUSPECT
        return HEALTHY

    def assignable(self, now: float | None = None) -> bool:
        """May pick_for_write target this node? Suspects, lame ducks
        and draining nodes are all out; with the plane disabled only
        dead nodes are (the pre-health contract)."""
        if not enabled():
            return not self.dead
        if self.lame_duck or self.draining or self.drain_requested:
            return False
        return self.state(now) == HEALTHY

    def read_demoted(self, now: float | None = None) -> bool:
        """Order this replica LAST for reads? Only genuine suspicion
        demotes reads — a lame-duck or draining node still serves GETs
        fine and must keep taking them while its data moves off."""
        if not enabled():
            return False
        return self.state(now) != HEALTHY

    def score(self, now: float | None = None) -> float:
        """A single scalar for operator surfaces: max of the normalized
        signals (1.0 = at threshold)."""
        now = time.monotonic() if now is None else now
        s = max(
            self.detector.phi(now) / max(phi_threshold(), 1e-9),
            self.err_ewma / max(err_ewma_threshold(), 1e-9),
        )
        return round(s, 3)


class HealthPlane:
    """The master's per-node health registry. All mutation happens on
    the heartbeat/sweep paths (under the master's node lock); reads are
    lock-free dict probes + pure functions of (record, now)."""

    def __init__(self) -> None:
        self.nodes: dict[str, NodeHealth] = {}
        self._lock = threading.Lock()

    def _get(self, url: str) -> NodeHealth:
        rec = self.nodes.get(url)
        if rec is None:
            with self._lock:
                rec = self.nodes.setdefault(url, NodeHealth(url))
        return rec

    # -- signal ingestion --------------------------------------------------
    def observe_heartbeat(self, url: str, req) -> None:
        """One beat arrived: feed arrival time + the node's counters
        and self-reported flags (master Heartbeat handler)."""
        rec = self._get(url)
        was = rec.state()
        rec.observe(
            time.monotonic(),
            io_errors=getattr(req, "io_errors", 0),
            request_errors=getattr(req, "request_errors", 0),
            lame_duck=getattr(req, "lame_duck", False),
            draining=getattr(req, "draining", False),
        )
        self._note_transition(rec, was)

    def observe_scrub(self, url: str, flagged: bool) -> None:
        """Disk-health signal from scrub strikes: the node's heartbeat
        scrub rows currently report corruption or quarantined shards."""
        rec = self._get(url)
        was = rec.state()
        rec.scrub_flagged = flagged
        self._note_transition(rec, was)

    # dead records linger this long for operator surfaces, then prune
    # (an autoscaled fleet would otherwise grow self.nodes unbounded)
    DEAD_TTL_S = 3600.0

    def note_dead(self, url: str) -> None:
        """Heartbeat stream teardown or liveness sweep declared the
        node gone; a later re-register revives it via observe()."""
        rec = self.nodes.get(url)
        if rec is not None:
            was = rec.state()
            rec.dead = True
            rec.dead_since = time.monotonic()
            self._note_transition(rec, was)
        self._prune(time.monotonic())

    def _prune(self, now: float) -> None:
        """Drop records dead past DEAD_TTL_S (decommissioned hosts)."""
        stale = [
            url
            for url, rec in list(self.nodes.items())
            if rec.dead and now - rec.dead_since > self.DEAD_TTL_S
        ]
        if stale:
            with self._lock:
                for url in stale:
                    rec = self.nodes.get(url)
                    if rec is not None and rec.dead:
                        del self.nodes[url]

    def request_drain(self, url: str, stop: bool = False) -> None:
        """Operator drain intent (node.drain): excluded from assignment
        and the RepairScheduler moves its data off."""
        self._get(url).drain_requested = not stop

    def draining_urls(self) -> set[str]:
        return {
            url
            for url, rec in list(self.nodes.items())
            if (rec.drain_requested or rec.draining) and not rec.dead
        }

    def _note_transition(self, rec: NodeHealth, was: str) -> None:
        nowst = rec.state()
        if nowst != was:
            from seaweedfs_tpu_torch.stats.metrics import HEALTH_TRANSITIONS

            HEALTH_TRANSITIONS.labels(nowst).inc()
            from seaweedfs_tpu_torch.util import wlog

            wlog.warning(
                "health: node %s %s -> %s%s",
                rec.url, was, nowst,
                (" (%s)" % ", ".join(rec._last_reasons))
                if nowst == SUSPECT and rec._last_reasons else "",
            )

    # -- verdicts ----------------------------------------------------------
    def state(self, url: str) -> str:
        rec = self.nodes.get(url)
        return HEALTHY if rec is None else rec.state()

    def assignable(self, url: str) -> bool:
        rec = self.nodes.get(url)
        return True if rec is None else rec.assignable()

    def suspect(self, url: str) -> bool:
        """Demote this replica for reads / hedge eagerly against it?"""
        rec = self.nodes.get(url)
        return False if rec is None else rec.read_demoted()

    def order_nodes(self, nodes: list) -> list:
        """Stable-partition read candidates: non-demoted first. The
        cluster-wide twin of the client breaker's _partition_healthy —
        every client of this master sees suspects last without having
        to burn its own timeout learning it."""
        if not enabled() or len(nodes) < 2:
            return nodes
        now = time.monotonic()

        def demoted(dn) -> bool:
            rec = self.nodes.get(dn.url)
            return rec is not None and rec.read_demoted(now)

        good = [dn for dn in nodes if not demoted(dn)]
        if not good or len(good) == len(nodes):
            return nodes
        return good + [dn for dn in nodes if demoted(dn)]

    # -- operator surface --------------------------------------------------
    def payload(self) -> dict:
        """Per-node score/state/signal rows for /cluster/health."""
        now = time.monotonic()
        self._prune(now)
        rows = {}
        for url, rec in sorted(self.nodes.items()):
            rows[url] = {
                "State": rec.state(now),
                "Score": rec.score(now),
                "Phi": round(rec.detector.phi(now), 2),
                # detector readiness + learned detection horizon: rigs
                # and runbooks barrier/bound on THESE, never on the
                # configured heartbeat interval (docs/ANALYSIS.md v4,
                # the gray-failure deflake)
                "Warmed": rec.detector.warmed(),
                "GateS": round(rec.detector.gate_s(), 3),
                "ErrEwma": round(rec.err_ewma, 2),
                "LameDuck": rec.lame_duck,
                "Draining": rec.draining or rec.drain_requested,
                "ScrubFlagged": rec.scrub_flagged,
                "Reasons": list(rec.suspicion_reasons(now)),
            }
        return {
            "Enabled": enabled(),
            "PhiThreshold": phi_threshold(),
            "Nodes": rows,
        }


class DiskWatchdog:
    """Volume-server-local graceful degradation: repeated EIO/ENOSPC on
    the serving path flip the node into read-only lame-duck mode —
    announced on the next heartbeat (lame_duck field) so the master
    stops assigning writes here, and enforced locally (POST/DELETE
    shed with 503) so in-flight clients fail over instead of grinding
    against a dying disk.

    Strikes decay: `strikes` IO errors within `window_s` trip it
    (WEED_LAMEDUCK_ERRS / WEED_LAMEDUCK_WINDOW_S). Tripping is sticky
    until an operator restarts the process — a disk that threw EIO
    three times is not healed by the passage of time."""

    def __init__(self, strikes: int | None = None, window_s: float | None = None):
        if strikes is None:
            try:
                strikes = int(os.environ.get("WEED_LAMEDUCK_ERRS", "3"))
            except ValueError:
                strikes = 3
        if window_s is None:
            try:
                window_s = float(os.environ.get("WEED_LAMEDUCK_WINDOW_S", "60"))
            except ValueError:
                window_s = 60.0
        self.strikes = max(1, strikes)
        self.window_s = window_s
        self.io_errors = 0  # cumulative, rides the heartbeat
        self.lame_duck = False
        self._recent: list[float] = []
        self._lock = threading.Lock()
        self.on_trip = None  # callback (e.g. force a heartbeat NOW)

    def note_io_error(self, exc: BaseException | None = None) -> bool:
        """Record one failure if it is disk-class (EIO/ENOSPC/EDQUOT);
        returns True when it was counted — False means "not a disk
        fault, handle it your usual way" (a DeadlineExceeded or a
        connection error must never strike the disk)."""
        import errno as _errno

        if exc is not None:
            eno = getattr(exc, "errno", None)
            if eno not in (_errno.EIO, _errno.ENOSPC, _errno.EDQUOT):
                return False
        now = time.monotonic()
        tripped = False
        with self._lock:
            self.io_errors += 1
            self._recent = [
                t for t in self._recent if now - t <= self.window_s
            ]
            self._recent.append(now)
            if not self.lame_duck and len(self._recent) >= self.strikes:
                self.lame_duck = True
                tripped = True
        if tripped:
            from seaweedfs_tpu_torch.util import wlog

            wlog.error(
                "health: %d IO errors within %.0fs — entering read-only "
                "lame-duck mode (writes shed with 503; restart to clear)",
                len(self._recent), self.window_s,
            )
            cb = self.on_trip
            if cb is not None:
                cb()
        return True
