"""SLO burn-rate engine (weedscope, docs/TELEMETRY.md).

Declarative objectives — per-daemon-kind availability and latency
targets, per plane (serve|scrub|repair|tier) — evaluated every
collector cycle against the ring TSDB, with MULTI-WINDOW MULTI-BURN
alerting (the SRE-workbook shape, scaled to this tree's timescales):

    burn = bad_fraction / (1 - target)

is computed over a FAST and a SLOW trailing window; the `slo_burn_rate`
alert goes active only when BOTH exceed the burn threshold. The fast
window makes a real incident page within seconds; the slow window
makes a short burst that never endangers the budget NOT page — the
flapping suppression single-threshold rules can't give. Resolution
carries hysteresis: once breaching, an objective stays active until
the fast burn cools below `threshold x resolve_factor`, so a burn
oscillating around the threshold pages once, not every other cycle.

Budgets are exported every cycle as `weed_slo_burn_rate{objective,
window}` and `weed_slo_budget_remaining{objective}`; the engine also
emits the SLO SCORECARD — availability, accepted p99.9, retry
amplification, MTTR, bytes-moved-per-rebuilt-byte, and a per-objective
verdict — the summary a soak run reads as its standing regression
gate.

`WEED_SLO=0` disables the engine (the collector then runs exactly the
pre-weedscope rule set); window/threshold knobs: `WEED_SLO_FAST_S`,
`WEED_SLO_SLOW_S`, `WEED_SLO_BURN`. Both windows must fit the ring's
retention (ring_cap x scrape interval — 40 min at the defaults).

The port of seaweedfs_tpu/telemetry/slo.py. On the port the scrub,
repair and tier planes whose spans the latency objectives read run on
the card: sweeps re-encode with K1, repairs rebuild with K1 and K4.
"""

from __future__ import annotations

import os
import threading
import time
from dataclasses import dataclass

from seaweedfs_tpu_torch.stats.metrics import SLO_BUDGET_REMAINING, SLO_BURN_RATE
from seaweedfs_tpu_torch.telemetry.alerts import AlertRule
from seaweedfs_tpu_torch.telemetry.ring import quantile_from_buckets

RULE_SLO_BURN = AlertRule(
    "slo_burn_rate", "critical", 0.0,
    "SLO error budget burning faster than the threshold over BOTH the "
    "fast and slow windows (multi-window multi-burn-rate: a burst that "
    "only burns the fast window never fires)",
)


def enabled() -> bool:
    return os.environ.get("WEED_SLO", "1") != "0"


@dataclass(frozen=True)
class SLOObjective:
    """One declarative objective.

    kind "availability": `target` is the good-request fraction; bad =
    5xx responses excluding 503/504, which are client-attributable by
    the health plane's doctrine (docs/HEALTH.md) — a tenant over its
    admission budget must not burn the cluster's SLO.

    kind "latency": `target` is the fraction of requests that must
    finish within `threshold_s`, measured from `family`'s buckets
    (optionally filtered to one `plane` — weed_span_seconds carries the
    plane label, weed_http_request_seconds is serve-only by nature)."""

    name: str
    kind: str  # availability | latency
    target: float  # good fraction, e.g. 0.999
    plane: str = "serve"
    daemon_kind: str = ""  # scrape-target kind filter; "" = all
    family: str = ""
    threshold_s: float = 0.5

    def describe(self) -> str:
        if self.kind == "availability":
            return f"{self.target:.4%} non-5xx"
        return (
            f"{self.target:.2%} of {self.plane} under "
            f"{self.threshold_s * 1000.0:.0f}ms"
        )


# The default objective set: cluster-wide serve availability and
# latency, volume-server availability (the data plane's own number,
# undiluted by gateways), and a tail-latency objective per background
# plane so repair/scrub/tier interference with serving has a budget of
# its own (PAPERS.md arXiv:1309.0186 — the interference is only
# manageable once it is measured against an explicit target).
DEFAULT_OBJECTIVES = (
    SLOObjective(
        "serve-availability", "availability", 0.999,
        family="weed_http_request_total",
    ),
    SLOObjective(
        "volume-availability", "availability", 0.999,
        daemon_kind="volume", family="weed_http_request_total",
    ),
    SLOObjective(
        "serve-latency", "latency", 0.99,
        family="weed_http_request_seconds", threshold_s=0.3,
    ),
    SLOObjective(
        "scrub-latency", "latency", 0.95, plane="scrub",
        family="weed_span_seconds", threshold_s=3.0,
    ),
    SLOObjective(
        "repair-latency", "latency", 0.95, plane="repair",
        family="weed_span_seconds", threshold_s=10.0,
    ),
    SLOObjective(
        "tier-latency", "latency", 0.95, plane="tier",
        family="weed_span_seconds", threshold_s=10.0,
    ),
)

_EPS = 1e-9


def _is_5xx_server_fault(labels: dict) -> bool:
    s = labels.get("status", "")
    return s.startswith("5") and s not in ("503", "504")


class SLOEngine:
    """Evaluates objectives against the collector's TargetStores and
    owns the burn-rate alert's hysteresis state. One instance per
    leader collector; stateless across restarts by design (budgets are
    windowed, not epoch-accounted — the windows ARE the state)."""

    def __init__(
        self,
        objectives: tuple[SLOObjective, ...] | list[SLOObjective] | None = None,
        fast_s: float | None = None,
        slow_s: float | None = None,
        burn_threshold: float | None = None,
        resolve_factor: float = 0.5,
    ):
        def _f(raw: str, default: float) -> float:
            try:
                return float(raw or default)
            except ValueError:
                return default

        self.objectives = tuple(objectives or DEFAULT_OBJECTIVES)
        # 5m/1h is the workbook's fast pair; soak/bench runs hand in
        # seconds-scale windows via telemetry_kwargs instead
        if fast_s is None:
            fast_s = _f(os.environ.get("WEED_SLO_FAST_S", ""), 300.0)
        self.fast_s = fast_s
        if slow_s is None:
            slow_s = _f(os.environ.get("WEED_SLO_SLOW_S", ""), 1800.0)
        self.slow_s = max(slow_s, self.fast_s)
        if burn_threshold is None:
            burn_threshold = _f(os.environ.get("WEED_SLO_BURN", ""), 1.0)
        self.burn_threshold = burn_threshold
        self.resolve_factor = max(0.0, min(1.0, resolve_factor))
        self._lock = threading.Lock()
        self._breaching: set[str] = set()
        self._rows: list[dict] = []
        self.last_eval_unix = 0.0

    # ------------------------------------------------------------------
    # measurement
    def _match(self, obj: SLOObjective, ts) -> bool:
        return not obj.daemon_kind or ts.kind == obj.daemon_kind

    def _bad_total(
        self, obj: SLOObjective, targets, window_s: float, now: float
    ) -> tuple[float, float]:
        """(bad, total) observation increases over the window, summed
        across matching targets."""
        bad = total = 0.0
        if obj.kind == "availability":
            family = obj.family or "weed_http_request_total"
            for ts in targets:
                if not self._match(obj, ts):
                    continue
                total += ts.increase_sum(family, window_s, now)
                bad += ts.increase_sum(
                    family, window_s, now, label_filter=_is_5xx_server_fault
                )
            return bad, total
        pooled = self._pooled_buckets(obj, targets, window_s, now)
        if not pooled:
            return 0.0, 0.0
        total = pooled.get(float("inf"), 0.0)
        # good = observations at-or-under the tightest bound >= the
        # threshold (conservative: a threshold between buckets judges
        # against the next bound up)
        finite = sorted(b for b in pooled if b != float("inf"))
        chosen = next(
            (b for b in finite if b >= obj.threshold_s - _EPS), float("inf")
        )
        good = pooled.get(chosen, total)
        return max(0.0, total - good), total

    def _pooled_buckets(
        self, obj: SLOObjective, targets, window_s: float, now: float
    ) -> dict[float, float]:
        plane = obj.plane

        def label_filter(labels: dict, _p=plane) -> bool:
            lp = labels.get("plane")
            return lp is None or lp == _p

        pooled: dict[float, float] = {}
        for ts in targets:
            if not self._match(obj, ts):
                continue
            for bound, inc in ts.bucket_increases(
                obj.family, window_s, now, label_filter=label_filter
            ).items():
                pooled[bound] = pooled.get(bound, 0.0) + inc
        return pooled

    @staticmethod
    def _burn(bad: float, total: float, target: float) -> float:
        if total <= _EPS:
            return 0.0
        return (bad / total) / max(_EPS, 1.0 - target)

    # ------------------------------------------------------------------
    # evaluation
    def evaluate(self, targets, now: float | None = None):
        """One cycle: compute both windows' burns per objective, drive
        the hysteresis state machine, export the gauges, and return
        AlertManager condition tuples for the collector to merge into
        its rule evaluation."""
        now = time.time() if now is None else now
        conds = []
        rows: list[dict] = []
        thr = self.burn_threshold
        for obj in self.objectives:
            bad_f, total_f = self._bad_total(obj, targets, self.fast_s, now)
            bad_s, total_s = self._bad_total(obj, targets, self.slow_s, now)
            burn_fast = self._burn(bad_f, total_f, obj.target)
            burn_slow = self._burn(bad_s, total_s, obj.target)
            budget = max(0.0, 1.0 - burn_slow)
            SLO_BURN_RATE.set(round(burn_fast, 4), obj.name, "fast")
            SLO_BURN_RATE.set(round(burn_slow, 4), obj.name, "slow")
            SLO_BUDGET_REMAINING.set(round(budget, 4), obj.name)
            with self._lock:
                if obj.name in self._breaching:
                    # hysteresis: stay active until the fast burn cools
                    # well below the threshold — no flap on resolve
                    active = burn_fast >= thr * self.resolve_factor
                else:
                    active = burn_fast > thr and burn_slow > thr
                if active:
                    self._breaching.add(obj.name)
                else:
                    self._breaching.discard(obj.name)
            verdict = (
                "burning" if active
                else ("at-risk" if max(burn_fast, burn_slow) > thr else "ok")
            )
            conds.append((
                RULE_SLO_BURN, obj.name, active, burn_fast,
                f"burn fast={burn_fast:.2f}x slow={burn_slow:.2f}x "
                f"(threshold {thr:.2f}x, objective {obj.describe()})",
            ))
            rows.append({
                "Objective": obj.name,
                "Kind": obj.kind,
                "Plane": obj.plane,
                "DaemonKind": obj.daemon_kind,
                "Target": obj.target,
                "ThresholdSeconds": obj.threshold_s
                if obj.kind == "latency" else None,
                "BurnFast": round(burn_fast, 4),
                "BurnSlow": round(burn_slow, 4),
                "BudgetRemaining": round(budget, 4),
                "BadFast": round(bad_f, 3),
                "TotalFast": round(total_f, 3),
                "BadSlow": round(bad_s, 3),
                "TotalSlow": round(total_s, 3),
                "Verdict": verdict,
            })
        with self._lock:
            self._rows = rows
            self.last_eval_unix = now
        return conds

    # ------------------------------------------------------------------
    # operator payloads
    def payload(self) -> dict:
        with self._lock:
            rows = [dict(r) for r in self._rows]
            breaching = sorted(self._breaching)
        return {
            "FastWindowSeconds": self.fast_s,
            "SlowWindowSeconds": self.slow_s,
            "BurnThreshold": self.burn_threshold,
            "LastEvalUnix": round(self.last_eval_unix, 3),
            "Breaching": breaching,
            "Objectives": rows,
        }

    def scorecard(self, targets, now: float | None = None) -> dict:
        """The soak gate's summary object (availability, accepted
        p99.9, retry amplification, MTTR, bytes-moved-per-rebuilt-
        byte), measured over the slow window, plus the
        per-objective burn verdicts from the latest evaluation."""
        now = time.time() if now is None else now
        w = self.slow_s
        total = bad = retries = 0.0
        ttr_sum = ttr_count = 0.0
        rb_read = rb_written = 0.0
        pooled_http: dict[float, float] = {}
        for ts in targets:
            total += ts.increase_sum("weed_http_request_total", w, now)
            bad += ts.increase_sum(
                "weed_http_request_total", w, now,
                label_filter=_is_5xx_server_fault,
            )
            retries += ts.increase_sum("weed_retry_total", w, now)
            ttr_sum += ts.increase_sum(
                "weed_time_to_repair_seconds_sum", w, now
            )
            ttr_count += ts.increase_sum(
                "weed_time_to_repair_seconds_count", w, now
            )
            rb_read += ts.increase_sum(
                "weed_ec_repair_bytes_read_total", w, now
            )
            rb_written += ts.increase_sum(
                "weed_ec_repair_bytes_written_total", w, now
            )
            for bound, inc in ts.bucket_increases(
                "weed_http_request_seconds", w, now
            ).items():
                pooled_http[bound] = pooled_http.get(bound, 0.0) + inc
        p999 = quantile_from_buckets(pooled_http, 0.999)
        with self._lock:
            rows = [dict(r) for r in self._rows]
        return {
            "WindowSeconds": w,
            "Requests": round(total, 3),
            "AvailabilityPct": round(
                100.0 * (1.0 - (bad / total if total > _EPS else 0.0)), 4
            ),
            "AcceptedP999Ms": None if p999 is None else round(p999 * 1000.0, 3),
            "RetryAmplification": round(
                (total + retries) / total, 4
            ) if total > _EPS else 1.0,
            "MTTRSeconds": round(ttr_sum / ttr_count, 3)
            if ttr_count > _EPS else None,
            "BytesMovedPerRebuiltByte": round(rb_read / rb_written, 4)
            if rb_written > _EPS else None,
            "Objectives": rows,
        }
