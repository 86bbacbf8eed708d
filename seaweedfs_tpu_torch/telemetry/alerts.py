"""SLO alert rules with firing→resolved transitions.

The collector evaluates a fixed rule set every scrape cycle and hands
this manager a list of *conditions* — (rule, target, active, value,
detail). The manager owns the state machine:

    ok → pending (condition active, younger than the rule's for_s)
       → firing  (condition held for for_s; logged, gauge set to 1)
       → resolved (condition cleared; logged, gauge back to 0,
                   appended to bounded history)

Only FIRING and the transitions are operator-visible; pending exists
so one slow scrape or one stray 500 doesn't flap an alert. Firing
alerts are re-exported as `weed_alert_firing{alert,target}` gauges so
any external scraper of the master inherits the cluster's alert state
for free (the reference pushes raw metrics and leaves alerting to
Prometheus; here the master IS the aggregator, so it must also be the
rule engine).

The port of seaweedfs_tpu/telemetry/alerts.py.
"""

from __future__ import annotations

import threading
import time
from dataclasses import dataclass, field

from seaweedfs_tpu_torch.stats.metrics import ALERT_FIRING
from seaweedfs_tpu_torch.util import wlog

_HISTORY_CAP = 128


@dataclass(frozen=True)
class AlertRule:
    name: str
    severity: str = "warning"  # warning | critical
    for_s: float = 0.0  # condition must hold this long before firing
    help: str = ""


@dataclass
class AlertState:
    rule: AlertRule
    target: str
    state: str = "pending"  # pending | firing
    since: float = field(default_factory=time.time)
    fired_at: float = 0.0
    value: float = 0.0
    detail: str = ""

    def to_dict(self) -> dict:
        return {
            "Alert": self.rule.name,
            "Severity": self.rule.severity,
            "Target": self.target,
            "State": self.state,
            "SinceUnix": round(self.since, 3),
            "FiredAtUnix": round(self.fired_at, 3),
            "Value": round(self.value, 6),
            "Detail": self.detail,
        }


class AlertManager:
    def __init__(self, on_fire=None):
        self._lock = threading.Lock()
        self._active: dict[tuple[str, str], AlertState] = {}
        self._history: list[dict] = []  # resolved alerts, newest last
        # called with each alert row on the pending→firing edge, AFTER
        # the state lock is released (the capsule coordinator captures
        # evidence from here; it must be free to read alert state)
        self.on_fire = on_fire

    def evaluate(
        self,
        conditions: list[tuple[AlertRule, str, bool, float, str]],
        now: float | None = None,
    ) -> None:
        """One evaluation cycle. `conditions` must carry EVERY rule ×
        target pair the caller checked this cycle — a pair absent from
        the list is treated as inactive (its alert resolves)."""
        now = time.time() if now is None else now
        seen: set[tuple[str, str]] = set()
        fired: list[dict] = []
        with self._lock:
            for rule, target, active, value, detail in conditions:
                key = (rule.name, target)
                seen.add(key)
                st = self._active.get(key)
                if active:
                    if st is None:
                        st = self._active[key] = AlertState(
                            rule, target, since=now
                        )
                    st.value, st.detail = value, detail
                    if st.state == "pending" and now - st.since >= rule.for_s:
                        st.state = "firing"
                        st.fired_at = now
                        ALERT_FIRING.set(1.0, rule.name, target)
                        wlog.warning(
                            "alert FIRING %s target=%s value=%.4g %s",
                            rule.name, target, value, detail,
                        )
                        fired.append(st.to_dict())
                else:
                    self._resolve(key, now)
            # rule×target pairs that vanished entirely (target forgotten)
            for key in [k for k in self._active if k not in seen]:
                self._resolve(key, now)
        if fired and self.on_fire is not None:
            for row in fired:
                try:
                    self.on_fire(row)
                except Exception as e:  # noqa: BLE001 — hook never breaks eval
                    wlog.warning("alert on_fire hook failed: %r", e)

    def _resolve(self, key: tuple[str, str], now: float) -> None:
        st = self._active.pop(key, None)
        if st is None:
            return
        # drop the row outright: a resolved alert for a forgotten target
        # must not linger as a 0-valued gauge on /metrics forever
        ALERT_FIRING.remove(st.rule.name, st.target)
        if st.state == "firing":
            wlog.info(
                "alert resolved %s target=%s after %.1fs",
                st.rule.name, st.target, now - st.fired_at,
            )
            row = st.to_dict()
            row["State"] = "resolved"
            row["ResolvedAtUnix"] = round(now, 3)
            self._history.append(row)
            del self._history[:-_HISTORY_CAP]

    # ------------------------------------------------------------------
    def firing(self) -> list[dict]:
        with self._lock:
            return [
                st.to_dict()
                for st in sorted(
                    self._active.values(),
                    key=lambda s: (s.rule.severity != "critical", s.since),
                )
                if st.state == "firing"
            ]

    def payload(self) -> dict:
        """/cluster/alerts body: firing + pending + resolved history."""
        with self._lock:
            active = sorted(
                self._active.values(),
                key=lambda s: (s.rule.severity != "critical", s.since),
            )
            return {
                "Firing": [
                    s.to_dict() for s in active if s.state == "firing"
                ],
                "Pending": [
                    s.to_dict() for s in active if s.state == "pending"
                ],
                "History": list(self._history[-32:]),
            }
