"""Leader-only master collector: scrape every node, ring it, alert.

Discovery is two-source, mirroring how the cluster already knows
itself: volume servers come off the heartbeat topology (the master
already holds them — no second membership protocol), gateways
(filer/S3/WebDAV) announce themselves over `/cluster/register`
(telemetry/announce.py) because nothing else in the control plane
knows they exist. Targets are STICKY: a node that drops out of the
topology (killed, frozen, partitioned) stays a scrape target until
`forget_after` so its staleness alert can fire — forgetting a dead
node instantly would resolve exactly the alert that matters most.

Every cycle: scrape all targets (bounded worker fan-out, per-target
timeout), ingest into the per-target ring TSDB, update the
staleness/up gauges, then evaluate the SLO rule set through the
AlertManager. Non-leaders idle — followers hold no topology, so their
aggregates would be empty lies.

The port of seaweedfs_tpu/telemetry/collector.py, with the same rule
set, thresholds and floors. stop() joins the collector's thread and
the capsule captures its alerts launched.
"""

from __future__ import annotations

import threading
import time
import urllib.request

from seaweedfs_tpu_torch.stats.metrics import SCRAPE_STALENESS, SCRAPE_UP
from seaweedfs_tpu_torch.telemetry import slo as slo_mod
from seaweedfs_tpu_torch.telemetry.alerts import AlertManager, AlertRule
from seaweedfs_tpu_torch.telemetry.parse import parse_prometheus_text
from seaweedfs_tpu_torch.telemetry.ring import TargetStore
from seaweedfs_tpu_torch.util import wlog

# The fixed SLO rule set (docs/TELEMETRY.md). for_s of one-ish scrape
# cycle on the flappable rules; staleness carries its own grace via the
# stale_factor threshold so for_s stays 0 (a target that missed 3
# scrapes is already long past "one slow cycle").
RULE_SCRAPE_STALE = AlertRule(
    "scrape_staleness", "critical", 0.0,
    "target unreachable: no successful /metrics scrape within the "
    "staleness bound (node down, frozen, or partitioned)",
)
RULE_ERROR_RATE = AlertRule(
    "error_rate", "critical", 0.0,
    "5xx fraction of served requests above threshold over the window",
)
RULE_SPAN_P99 = AlertRule(
    "span_p99", "warning", 0.0,
    "p99 span duration above threshold over the window",
)
RULE_SCRUB_CORRUPT = AlertRule(
    "scrub_corruptions", "critical", 0.0,
    "scrubber found new corruption on this node within the window",
)
RULE_REPAIR_DEPTH = AlertRule(
    "repair_queue_depth", "warning", 0.0,
    "master repair scheduler tracking more damage than the bound",
)
RULE_ADMISSION = AlertRule(
    "admission_reject_rate", "warning", 0.0,
    "per-client admission control shedding requests (503 + Retry-After) "
    "above the sustained-rate bound — a tenant is over budget or the "
    "node is saturated (docs/QOS.md)",
)
RULE_REPL_LAG = AlertRule(
    "replication_lag", "warning", 0.0,
    "cross-cluster replication consumer lag (uncommitted filer events "
    "in the notification queue) above the bound — the remote cluster "
    "is falling behind the local one (docs/TIERING.md)",
)


class ClusterCollector:
    def __init__(
        self,
        master,
        interval: float = 10.0,
        scrape_timeout: float = 5.0,
        ring_cap: int = 240,
        window_s: float = 120.0,
        stale_factor: float = 3.0,
        forget_after: float = 3600.0,
        error_rate_threshold: float = 0.05,
        span_p99_threshold_s: float = 2.0,
        repair_depth_threshold: int = 8,
        admission_reject_threshold: float = 1.0,
        repl_lag_threshold: float = 1000.0,
        slo_objectives=None,
        slo_fast_s: float | None = None,
        slo_slow_s: float | None = None,
        slo_burn_threshold: float | None = None,
    ):
        self.master = master
        self.interval = interval
        self.scrape_timeout = scrape_timeout
        self.ring_cap = ring_cap
        # rate/quantile window; floored to a few scrape cycles so the
        # increase() math always has >= 2 samples at steady state
        self.window_s = max(window_s, 3.0 * interval)
        self.stale_after = max(stale_factor * interval, interval + 1.0)
        # dead-node TTL (the NodeHealth 1h prune, mirrored): the floor
        # guarantees the staleness alert gets its full firing window
        # before the target — and with it the alert's rule×target pair —
        # is forgotten and auto-resolved
        self.forget_after = max(forget_after, self.stale_after + 2.0 * interval)
        self.error_rate_threshold = error_rate_threshold
        self.span_p99_threshold_s = span_p99_threshold_s
        self.repair_depth_threshold = repair_depth_threshold
        self.admission_reject_threshold = admission_reject_threshold
        self.repl_lag_threshold = repl_lag_threshold
        self.alerts = AlertManager()
        self.slo = (
            slo_mod.SLOEngine(
                objectives=slo_objectives,
                fast_s=slo_fast_s,
                slow_s=slo_slow_s,
                burn_threshold=slo_burn_threshold,
            )
            if slo_mod.enabled()
            else None
        )
        self.targets: dict[str, TargetStore] = {}
        self._targets_lock = threading.Lock()
        self._stop = threading.Event()
        self._thread: threading.Thread | None = None
        self.cycles = 0
        self.last_cycle_unix = 0.0

    # ------------------------------------------------------------------
    # lifecycle
    def start(self) -> None:
        self._thread = threading.Thread(
            target=self._loop, daemon=True, name="telemetry-collector"
        )
        self._thread.start()

    def stop(self) -> None:
        """End the loop and wait for it, and for the capsule captures
        an alert's on_fire hook launched (CaptureCoordinator.join)."""
        self._stop.set()
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        join = getattr(self.alerts.on_fire, "join", None)
        if join is not None:
            join()

    def _loop(self) -> None:
        while not self._stop.wait(self.interval):
            if not self.master.is_leader:
                continue
            try:
                self.collect_once()
            except Exception as e:  # noqa: BLE001 — the plane must survive
                wlog.error("telemetry: collect cycle failed: %r", e)

    # ------------------------------------------------------------------
    # discovery
    def _discover(self) -> None:
        now = time.time()
        seen: dict[str, str] = {f"{self.master.host}:{self.master.port}": "master"}
        for dn in self.master.topology.data_nodes():
            seen[dn.url] = "volume"
        for addr, row in self.master.gateway_registrations().items():
            seen[addr] = row["kind"]
        with self._targets_lock:
            for url, kind in seen.items():
                ts = self.targets.get(url)
                if ts is None:
                    self.targets[url] = TargetStore(url, kind, self.ring_cap)
                elif ts.kind != kind:
                    ts.kind = kind
            # sticky forget: only targets BOTH absent from discovery
            # and stale past forget_after are dropped (their alerts
            # resolve via the evaluate() absent-pair rule)
            for url in [u for u in self.targets if u not in seen]:
                if self.targets[url].staleness(now) > self.forget_after:
                    del self.targets[url]
                    # remove, don't zero: a forgotten node must vanish
                    # from /metrics, not haunt it as a 0-valued row
                    SCRAPE_STALENESS.remove(url)
                    SCRAPE_UP.remove(url)
                    wlog.info(
                        "telemetry: forgot dead target %s after %.0fs",
                        url, self.forget_after,
                    )

    # ------------------------------------------------------------------
    # scrape
    def _scrape_one(self, ts: TargetStore) -> None:
        try:
            with urllib.request.urlopen(
                f"http://{ts.url}/metrics", timeout=self.scrape_timeout
            ) as r:
                text = r.read().decode("utf-8", "replace")
            ts.record_scrape(parse_prometheus_text(text))
        except (OSError, ValueError) as e:
            ts.record_failure(str(e))

    def collect_once(self) -> None:
        """One full cycle: discover → scrape (bounded fan-out) →
        gauges → alert evaluation. Also the test/bench seam: callers
        drive cycles synchronously without the background thread."""
        self._discover()
        with self._targets_lock:
            targets = list(self.targets.values())
        # bounded fan-out: one slow target must not serialize the cycle
        # behind its timeout, but concurrency stays capped at 8 however
        # many nodes register — chunked waves, not a thread per node.
        # A scrape stuck past its deadline (DNS stall is outside
        # urlopen's timeout) delays only its wave; the threads are
        # daemonic and urlopen's socket timeout bounds the common case.
        for i in range(0, len(targets), 8):
            wave = [
                threading.Thread(
                    target=self._scrape_one, args=(ts,), daemon=True
                )
                for ts in targets[i : i + 8]
            ]
            for t in wave:
                t.start()
            for t in wave:
                t.join(self.scrape_timeout + 2.0)
        now = time.time()
        for ts in targets:
            SCRAPE_STALENESS.set(round(ts.staleness(now), 3), ts.url)
            SCRAPE_UP.set(
                1.0 if (ts.last_success and ts.staleness(now) < self.stale_after)
                else 0.0,
                ts.url,
            )
        self._evaluate(targets, now)
        self.cycles += 1
        self.last_cycle_unix = now

    # ------------------------------------------------------------------
    # alert rules
    def _evaluate(self, targets: list[TargetStore], now: float) -> None:
        conds: list[tuple[AlertRule, str, bool, float, str]] = []
        w = self.window_s
        for ts in targets:
            stale = ts.staleness(now)
            conds.append((
                RULE_SCRAPE_STALE, ts.url, stale > self.stale_after, stale,
                f"last successful scrape {stale:.1f}s ago"
                + (f" ({ts.last_error})" if ts.last_error else ""),
            ))
            if not ts.last_success:
                continue  # no samples: only staleness can judge it
            total = ts.rate_sum("weed_http_request_total", w, now)
            errs = ts.rate_sum(
                "weed_http_request_total", w, now,
                label_filter=lambda l: l.get("status", "").startswith("5"),
            )
            frac = errs / total if total > 0.01 else 0.0
            conds.append((
                RULE_ERROR_RATE, ts.url,
                frac > self.error_rate_threshold, frac,
                f"{errs:.2f}/s of {total:.2f}/s requests are 5xx",
            ))
            p99 = ts.quantile("weed_span_seconds", 0.99, w, now)
            conds.append((
                RULE_SPAN_P99, ts.url,
                p99 is not None and p99 > self.span_p99_threshold_s,
                p99 or 0.0,
                f"span p99 {0.0 if p99 is None else p99 * 1000.0:.1f}ms "
                f"over {w:.0f}s",
            ))
            corrupt = ts.increase_sum(
                "weed_scrub_corruptions_found_total", w, now
            )
            conds.append((
                RULE_SCRUB_CORRUPT, ts.url, corrupt > 0, corrupt,
                f"{corrupt:.0f} new corruption(s) in {w:.0f}s",
            ))
            # QoS plane: sustained shedding means a tenant is over
            # budget (or the node is saturated) — surface it before the
            # tenant's own dashboards do
            shed = ts.rate_sum("weed_admission_rejected_total", w, now)
            conds.append((
                RULE_ADMISSION, ts.url,
                shed > self.admission_reject_threshold, shed,
                f"{shed:.2f}/s requests shed by admission control "
                f"over {w:.0f}s",
            ))
            # replication plane: the producer (filer) exposes the
            # consumer group's queue depth as a gauge — a consumer
            # that stalled (or was killed with WEED_REPL=0 and
            # forgotten) shows up as monotonically growing lag
            lag = ts.last_value("weed_replication_lag_events")
            conds.append((
                RULE_REPL_LAG, ts.url,
                lag is not None and lag > self.repl_lag_threshold,
                lag or 0.0,
                f"{0 if lag is None else lag:.0f} filer event(s) behind "
                f"(bound {self.repl_lag_threshold:.0f})",
            ))
        # master-local: the repair scheduler's tracked-damage depth
        depth = 0
        if getattr(self.master, "repair", None) is not None:
            try:
                depth = len(self.master.repair.queue_snapshot().get("Tasks", []))
            except Exception:  # noqa: BLE001 — telemetry must not throw
                depth = 0
        conds.append((
            RULE_REPAIR_DEPTH, f"{self.master.host}:{self.master.port}",
            depth > self.repair_depth_threshold, float(depth),
            f"{depth} damage task(s) tracked "
            f"(bound {self.repair_depth_threshold})",
        ))
        if self.slo is not None:
            conds.extend(self.slo.evaluate(targets, now))
        self.alerts.evaluate(conds, now)

    # ------------------------------------------------------------------
    # operator payloads
    def health_payload(self) -> dict:
        from seaweedfs_tpu_torch.stats.metrics import push_status

        now = time.time()
        with self._targets_lock:
            rows = {
                url: ts.health_row(now, stale_after=self.stale_after)
                for url, ts in sorted(self.targets.items())
            }
        alerts = self.alerts.payload()
        return {
            "IsLeader": self.master.is_leader,
            "IntervalSeconds": self.interval,
            "WindowSeconds": self.window_s,
            "StaleAfterSeconds": round(self.stale_after, 3),
            "Cycles": self.cycles,
            "LastCycleUnix": round(self.last_cycle_unix, 3),
            "Targets": rows,
            "FiringAlerts": len(alerts["Firing"]),
            "PendingAlerts": len(alerts["Pending"]),
            "Push": push_status(),
        }

    def slo_payload(self) -> dict:
        """/cluster/slo body: engine config + latest per-objective burn
        rows + the soak-gate scorecard over the slow window."""
        if self.slo is None:
            return {"Enabled": False}
        with self._targets_lock:
            targets = list(self.targets.values())
        body = self.slo.payload()
        body["Enabled"] = True
        body["Scorecard"] = self.slo.scorecard(targets)
        return body

    # series families worth freezing into an incident capsule — the
    # request/span signals every objective reads, plus the alert/SLO
    # state itself; everything else stays out so a capsule of a
    # many-node cluster stays megabytes, not the whole TSDB
    _CAPSULE_FAMILIES = (
        "weed_http_request",
        "weed_span_seconds",
        "weed_scrape_",
        "weed_slo_",
        "weed_alert_firing",
        "weed_retry_total",
        "weed_time_to_repair_seconds",
        "weed_admission_rejected_total",
        "weed_scrub_corruptions_found_total",
    )

    def window_payload(self, window_s: float | None = None) -> dict:
        """The capsule's TSDB section: the relevant families' raw
        samples over the SLO slow window (or `window_s`), per target."""
        w = window_s or (self.slo.slow_s if self.slo is not None
                         else 4.0 * self.window_s)
        now = time.time()
        with self._targets_lock:
            targets = list(self.targets.values())
        return {
            "WindowSeconds": w,
            "Targets": {
                ts.url: ts.dump_window(self._CAPSULE_FAMILIES, w, now)
                for ts in targets
            },
        }

    def up_targets(self) -> list[str]:
        """Scrape targets currently considered up — the capsule
        coordinator's fan-out set for cluster-scoped alerts."""
        now = time.time()
        with self._targets_lock:
            return [
                ts.url
                for ts in self.targets.values()
                if ts.last_success and ts.staleness(now) < self.stale_after
            ]

    def top_payload(self, n: int = 10) -> dict:
        """Busiest nodes by req/s (with 5xx rate and http p99) and
        biggest volumes by size — the cluster.top shell surface."""
        now = time.time()
        w = self.window_s
        with self._targets_lock:
            targets = list(self.targets.values())
        # QoS plane: heartbeat-reported live load per volume server
        # (the same numbers pick_for_write's power-of-two-choices uses)
        load_by_url = {
            dn.url: (dn.in_flight, dn.write_queue_depth)
            for dn in self.master.topology.data_nodes()
        }
        nodes = []
        for ts in targets:
            if not ts.last_success:
                continue
            total = ts.rate_sum("weed_http_request_total", w, now)
            errs = ts.rate_sum(
                "weed_http_request_total", w, now,
                label_filter=lambda l: l.get("status", "").startswith("5"),
            )
            p99 = ts.quantile("weed_http_request_seconds", 0.99, w, now)
            in_flight, queue_depth = load_by_url.get(ts.url, (None, None))
            nodes.append({
                "Url": ts.url,
                "Kind": ts.kind,
                "ReqPerSec": round(total, 3),
                "ErrPerSec": round(errs, 3),
                "P99Ms": None if p99 is None else round(p99 * 1000.0, 3),
                "InFlight": in_flight,
                "WriteQueueDepth": queue_depth,
            })
        nodes.sort(key=lambda r: -r["ReqPerSec"])
        volumes = []
        for dn in self.master.topology.data_nodes():
            for vid, info in list(dn.volumes.items()):
                volumes.append({
                    "VolumeId": vid,
                    "Node": dn.url,
                    "Collection": info.collection,
                    "SizeBytes": info.size,
                    "FileCount": info.file_count,
                })
        volumes.sort(key=lambda r: -r["SizeBytes"])
        return {"Nodes": nodes[:n], "Volumes": volumes[:n]}
