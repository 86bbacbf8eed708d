"""Prometheus-style metrics: registry, counters, gauges, histograms and
text exposition.

The port carries the families its modules name (the EC pipelines, the
degraded read, the store, the volume server, its mini loop and write
path, the master's health plane, the scrub engine and repair
scheduler, the tier engine, the client's retries and hedged reads, the
push loop, and the cluster telemetry plane: scrape health, alerts, SLO
burn and incident capsules, and replication's lag and applied events);
the reference's handoff family comes with its plane.

A Registry renders Prometheus text format 0.0.4 so any scraper
understands it (weed/stats/metrics.go:14-60). The push loop to a
pushgateway (start_push_loop) is configured by the master's heartbeat
reply.
"""

from __future__ import annotations

import bisect
import os
import threading
import time
import urllib.request

DEFAULT_BUCKETS = (
    0.0001, 0.0003, 0.001, 0.003, 0.01, 0.03, 0.1, 0.3, 1.0, 3.0, 10.0
)

# weedscope (docs/TELEMETRY.md): histogram bucket exemplars — each
# bucket remembers the LAST trace id observed into it, rendered
# OpenMetrics-style (`... # {trace_id="..."} v`) so a burning SLO links
# straight to a concrete trace. WEED_SCOPE=0 kills recording AND
# rendering (the exposition reverts to plain 0.0.4 text).
_EXEMPLARS_ENABLED = os.environ.get("WEED_SCOPE", "1") != "0"


def exemplars_enabled() -> bool:
    return _EXEMPLARS_ENABLED


def set_exemplars_enabled(on: bool) -> None:
    """Runtime toggle (bench A/B arms and tests flip this in-process)."""
    global _EXEMPLARS_ENABLED
    _EXEMPLARS_ENABLED = bool(on)


def _fmt_labels(labels: dict[str, str]) -> str:
    if not labels:
        return ""
    inner = ",".join(f'{k}="{v}"' for k, v in sorted(labels.items()))
    return "{" + inner + "}"


class Counter:
    def __init__(self, name: str, help_: str, label_names: tuple[str, ...] = ()):
        self.name = name
        self.help = help_
        self.label_names = label_names
        self._values: dict[tuple[str, ...], float] = {}
        self._lock = threading.Lock()

    def labels(self, *label_values: str) -> "_CounterChild":
        return _CounterChild(self, tuple(label_values))

    def inc(self, amount: float = 1.0) -> None:
        self.labels().inc(amount)

    def value(self, *label_values: str) -> float:
        return self._values.get(tuple(label_values), 0.0)

    def _add(self, key: tuple[str, ...], amount: float) -> None:
        with self._lock:
            self._values[key] = self._values.get(key, 0.0) + amount

    def render(self) -> list[str]:
        lines = [f"# HELP {self.name} {self.help}", f"# TYPE {self.name} counter"]
        with self._lock:
            items = sorted(self._values.items())
        for key, val in items or [((), 0.0)]:
            labels = dict(zip(self.label_names, key))
            lines.append(f"{self.name}{_fmt_labels(labels)} {val}")
        return lines


class _CounterChild:
    def __init__(self, parent: Counter, key: tuple[str, ...]):
        self._parent = parent
        self._key = key

    def inc(self, amount: float = 1.0) -> None:
        self._parent._add(self._key, amount)


class Gauge:
    def __init__(self, name: str, help_: str, label_names: tuple[str, ...] = ()):
        self.name = name
        self.help = help_
        self.label_names = label_names
        self._values: dict[tuple[str, ...], float] = {}
        self._lock = threading.Lock()

    def set(self, value: float, *label_values: str) -> None:
        with self._lock:
            self._values[tuple(label_values)] = value

    def add(self, amount: float, *label_values: str) -> None:
        key = tuple(label_values)
        with self._lock:
            self._values[key] = self._values.get(key, 0.0) + amount

    def value(self, *label_values: str) -> float:
        return self._values.get(tuple(label_values), 0.0)

    def remove(self, *label_values: str) -> None:
        """Drop one label row entirely. Gauges keyed by node/target URL
        grow a row per member ever seen; a departed node must DISAPPEAR
        from /metrics (telemetry/collector.py's dead-node TTL), not
        linger as a frozen 0.0 row forever on autoscaled fleets."""
        with self._lock:
            self._values.pop(tuple(label_values), None)

    def render(self) -> list[str]:
        lines = [f"# HELP {self.name} {self.help}", f"# TYPE {self.name} gauge"]
        with self._lock:
            items = sorted(self._values.items())
        for key, val in items or [((), 0.0)]:
            labels = dict(zip(self.label_names, key))
            lines.append(f"{self.name}{_fmt_labels(labels)} {val}")
        return lines


class Histogram:
    def __init__(
        self,
        name: str,
        help_: str,
        label_names: tuple[str, ...] = (),
        buckets: tuple[float, ...] = DEFAULT_BUCKETS,
    ):
        self.name = name
        self.help = help_
        self.label_names = label_names
        self.buckets = tuple(sorted(buckets))
        self._counts: dict[tuple[str, ...], list[int]] = {}
        self._sums: dict[tuple[str, ...], float] = {}
        # (label key, bucket idx) -> (trace_id, observed value): the
        # last exemplar per bucket (weedscope). Written only through
        # put_exemplar — observe() itself never pays for it, so the
        # untraced hot path is byte-identical to the pre-exemplar one.
        self._exemplars: dict[tuple[tuple[str, ...], int], tuple[str, float]] = {}
        self._lock = threading.Lock()

    def observe(self, value: float, *label_values: str) -> None:
        key = tuple(label_values)
        idx = bisect.bisect_left(self.buckets, value)
        with self._lock:
            counts = self._counts.setdefault(key, [0] * (len(self.buckets) + 1))
            counts[idx] += 1
            self._sums[key] = self._sums.get(key, 0.0) + value

    def put_exemplar(
        self, value: float, trace_id: str, *label_values: str
    ) -> None:
        """Remember `trace_id` as the latest exemplar for the bucket
        `value` falls into. Callers that already hold a trace id (the
        dispatch funnel's traced branch, the span-ring drain, the C
        fast-path complete callback) call this AFTER observe(); it is
        deliberately not folded into observe() so untraced requests pay
        nothing."""
        if not _EXEMPLARS_ENABLED or not trace_id:
            return
        key = tuple(label_values)
        idx = bisect.bisect_left(self.buckets, value)
        with self._lock:
            self._exemplars[(key, idx)] = (trace_id, value)

    def time(self, *label_values: str) -> "_Timer":
        return _Timer(self, label_values)

    def count(self, *label_values: str) -> int:
        return sum(self._counts.get(tuple(label_values), []))

    def render(self) -> list[str]:
        lines = [f"# HELP {self.name} {self.help}", f"# TYPE {self.name} histogram"]
        with self._lock:
            # copy each counts LIST, not just the dict: observe()
            # mutates the per-child list in place from serving threads,
            # and a render iterating the live list can emit bucket
            # cumulative counts that disagree with the _count line it
            # writes a few lines later (non-monotone exposition that
            # trips real scrapers)
            items = sorted(
                (key, list(counts)) for key, counts in self._counts.items()
            )
            sums = dict(self._sums)
            exemplars = dict(self._exemplars) if _EXEMPLARS_ENABLED else {}
        for key, counts in items:
            labels = dict(zip(self.label_names, key))
            cum = 0
            for i, (bound, c) in enumerate(zip(self.buckets, counts)):
                cum += c
                lb = dict(labels, le=repr(bound))
                ex = exemplars.get((key, i))
                lines.append(
                    f"{self.name}_bucket{_fmt_labels(lb)} {cum}"
                    + (
                        f' # {{trace_id="{ex[0]}"}} {ex[1]:.6f}'
                        if ex is not None
                        else ""
                    )
                )
            cum += counts[-1]
            lb = dict(labels, le="+Inf")
            ex = exemplars.get((key, len(self.buckets)))
            lines.append(
                f"{self.name}_bucket{_fmt_labels(lb)} {cum}"
                + (
                    f' # {{trace_id="{ex[0]}"}} {ex[1]:.6f}'
                    if ex is not None
                    else ""
                )
            )
            lines.append(f"{self.name}_sum{_fmt_labels(labels)} {sums.get(key, 0.0)}")
            lines.append(f"{self.name}_count{_fmt_labels(labels)} {cum}")
        return lines


class _Timer:
    def __init__(self, hist: Histogram, label_values: tuple[str, ...]):
        self._hist = hist
        self._labels = label_values

    def __enter__(self):
        self._start = time.perf_counter()
        return self

    def __exit__(self, *exc):
        self._hist.observe(time.perf_counter() - self._start, *self._labels)
        return False


class Registry:
    def __init__(self):
        self._metrics: list = []
        self._lock = threading.Lock()
        self._prerender_hooks: list = []

    def add_prerender_hook(self, fn) -> None:
        """Register a callable run before every text exposition — lets
        a subsystem that aggregates lazily (the tracing plane drains
        its span ring into histograms off the hot path) flush right
        before a scrape or push sees the numbers."""
        with self._lock:
            self._prerender_hooks.append(fn)

    def counter(self, name: str, help_: str, label_names: tuple[str, ...] = ()) -> Counter:
        m = Counter(name, help_, label_names)
        with self._lock:
            self._metrics.append(m)
        return m

    def gauge(self, name: str, help_: str, label_names: tuple[str, ...] = ()) -> Gauge:
        m = Gauge(name, help_, label_names)
        with self._lock:
            self._metrics.append(m)
        return m

    def histogram(
        self,
        name: str,
        help_: str,
        label_names: tuple[str, ...] = (),
        buckets: tuple[float, ...] = DEFAULT_BUCKETS,
    ) -> Histogram:
        m = Histogram(name, help_, label_names, buckets)
        with self._lock:
            self._metrics.append(m)
        return m

    def render_text(self) -> str:
        """Prometheus text exposition format 0.0.4."""
        with self._lock:
            hooks = list(self._prerender_hooks)
            metrics = list(self._metrics)
        for fn in hooks:
            fn()
        lines: list[str] = []
        for m in metrics:
            lines.extend(m.render())
        return "\n".join(lines) + "\n"


DEFAULT_REGISTRY = Registry()

# --- request tracing & gateway instrumentation (docs/TRACING.md) ------------
# One family for EVERY FastHandler server (volume/master/filer/s3/webdav/
# worker), observed centrally in util/httpd.serve_connection — this is
# what closes the "S3 and WebDAV expose no metrics" gap: the gateways
# ride the same mini loop, so they get counters + histograms for free.
HTTP_REQUEST_COUNTER = DEFAULT_REGISTRY.counter(
    "weed_http_request_total",
    "requests served through the mini request loop",
    ("server", "method", "status"),
)
HTTP_REQUEST_HISTOGRAM = DEFAULT_REGISTRY.histogram(
    "weed_http_request_seconds",
    "request dispatch latency through the mini request loop",
    ("server", "method"),
)
SPAN_HISTOGRAM = DEFAULT_REGISTRY.histogram(
    "weed_span_seconds",
    "trace span durations by span name and plane (serve|scrub|repair|tier)",
    ("name", "plane"),
)

# --- scrub & self-healing plane (docs/SCRUB.md) -----------------------------
SCRUB_SCANNED = DEFAULT_REGISTRY.counter(
    "weed_scrub_scanned_bytes_total",
    "bytes verified by the background scrubber",
    ("server", "kind"),  # kind: plain | ec
)
SCRUB_CORRUPTIONS = DEFAULT_REGISTRY.counter(
    "weed_scrub_corruptions_found_total",
    "corruption events found by the scrubber",
    ("server", "kind"),
)
SCRUB_ECC_FALLBACK = DEFAULT_REGISTRY.counter(
    "weed_scrub_ecc_fallback_total",
    "scrub sweeps that expected a .ecc sidecar but fell back to the "
    "full parity re-verify (sidecar missing or stale)",
    ("server", "reason"),  # reason: missing | stale
)
SCRUB_QUARANTINED = DEFAULT_REGISTRY.gauge(
    "scrub_quarantined_shards",
    "EC shards currently quarantined on this server",
    ("server",),
)
REPAIR_STARTED = DEFAULT_REGISTRY.counter(
    "weed_repair_started_total",
    "repairs launched by the master scheduler",
    ("kind",),  # kind: ec_rebuild | replicate | replace
)
REPAIR_SUCCEEDED = DEFAULT_REGISTRY.counter(
    "weed_repair_succeeded_total",
    "repairs completed by the master scheduler",
    ("kind",),
)
REPAIR_FAILED = DEFAULT_REGISTRY.counter(
    "weed_repair_failed_total",
    "repairs that errored (will back off and retry)",
    ("kind",),
)
TIME_TO_REPAIR = DEFAULT_REGISTRY.histogram(
    "weed_time_to_repair_seconds",
    "first detection of damage to verified repair",
    ("kind",),
    buckets=(1.0, 5.0, 15.0, 60.0, 300.0, 900.0, 3600.0, 14400.0),
)

# --- QoS / tail-latency plane (docs/QOS.md) ---------------------------------
# Hedged reads (client side): fired = second attempt launched after the
# adaptive delay; won = the hedge (not the primary) returned first;
# cancelled = the losing attempt's connection was torn down mid-flight.
HEDGE_FIRED = DEFAULT_REGISTRY.counter(
    "weed_hedge_fired_total",
    "hedged read second attempts launched after the adaptive delay",
)
HEDGE_WON = DEFAULT_REGISTRY.counter(
    "weed_hedge_won_total",
    "hedged reads where the second attempt beat the primary",
)
HEDGE_CANCELLED = DEFAULT_REGISTRY.counter(
    "weed_hedge_cancelled_total",
    "losing hedged-read attempts cancelled (connection torn down)",
)
HEDGE_SERVED = DEFAULT_REGISTRY.counter(
    "weed_hedge_served_total",
    "requests a server observed carrying the x-weed-hedge hop header",
    ("server",),
)
# --- EC degraded reads & repair-bandwidth accounting (docs/SCRUB.md) --------
# Every degraded/repair byte moved is counted so bench can report
# bytes-moved-per-rebuilt-byte and degraded-read p99 vs healthy p99.
EC_DEGRADED_READS = DEFAULT_REGISTRY.counter(
    "weed_ec_degraded_read_total",
    "EC intervals served by reconstruction (a shard was lost/quarantined)",
)
EC_TILE_CACHE = DEFAULT_REGISTRY.counter(
    "weed_ec_tile_cache_total",
    "reconstructed-tile cache probes on the degraded read path",
    ("result",),  # result: hit | miss
)
EC_REPAIR_BYTES_READ = DEFAULT_REGISTRY.counter(
    "weed_ec_repair_bytes_read_total",
    "survivor bytes gathered by EC rebuild, by where they came from",
    ("source",),  # source: local | remote
)
EC_REPAIR_BYTES_WRITTEN = DEFAULT_REGISTRY.counter(
    "weed_ec_repair_bytes_written_total",
    "rebuilt shard bytes written by EC rebuild",
)
EC_REPAIR_DONATED_BYTES = DEFAULT_REGISTRY.counter(
    "weed_ec_repair_donated_bytes_total",
    "tile bytes degraded serving handed to an in-progress rebuild",
)

ADMISSION_REJECTED = DEFAULT_REGISTRY.counter(
    "weed_admission_rejected_total",
    "requests shed with 503 + Retry-After by per-client admission control",
    ("server",),
)
GROUP_COMMIT_BATCHES = DEFAULT_REGISTRY.counter(
    "weed_group_commit_batches_total",
    "group-commit windows committed (one pwritev + one flush each)",
)
GROUP_COMMIT_WRITES = DEFAULT_REGISTRY.counter(
    "weed_group_commit_writes_total",
    "needle writes that rode a group-commit window",
)
COMMIT_FLUSHES = DEFAULT_REGISTRY.counter(
    "weed_commit_flush_total",
    "durability flushes (fsync) issued by the volume write path",
)

# --- robustness plane: unified retries + deadlines (docs/CHAOS.md) ----------
RETRY_TOTAL = DEFAULT_REGISTRY.counter(
    "weed_retry_total",
    "retries granted by the unified RetryPolicy, by call-site label",
    ("site",),
)
RETRY_BUDGET_EXHAUSTED = DEFAULT_REGISTRY.counter(
    "weed_retry_budget_exhausted_total",
    "retries refused because the process-wide retry budget ran dry",
)
DEADLINE_REJECTED = DEFAULT_REGISTRY.counter(
    "weed_deadline_rejected_total",
    "requests 504-fast-rejected at dispatch: X-Weed-Deadline already expired",
    ("server",),
)

# --- lifecycle tiering + cross-cluster replication (docs/TIERING.md) --------
VOLUME_READS = DEFAULT_REGISTRY.counter(
    "weed_volume_read_total",
    "needle GETs served, per volume — the tier scheduler's "
    "access-temperature signal (scraped off the node by the collector)",
    ("volume",),
)
TIER_MOVES = DEFAULT_REGISTRY.counter(
    "weed_tier_moves_total",
    "EC volume tier transitions completed on this node",
    ("direction", "result"),  # direction: out | in; result: ok | error
)
TIER_BYTES = DEFAULT_REGISTRY.counter(
    "weed_tier_bytes_total",
    "shard bytes moved to/from the tier backend",
    ("direction",),  # out | in
)
TIER_REMOTE_READS = DEFAULT_REGISTRY.counter(
    "weed_tier_remote_read_total",
    "ranged sub-shard reads served from the tier backend",
)
TIER_REMOTE_READ_ERRORS = DEFAULT_REGISTRY.counter(
    "weed_tier_remote_read_errors_total",
    "tier backend reads that failed (the read degraded to "
    "peer-fetch/reconstruction instead)",
)
# --- the port's CUDA kernels ------------------------------------------------
# Read off the wrappers' launch counters (_build.COUNTERS) at every
# exposition: a process's launches on its card, so a run that drives
# servers in processes of their own can see which kernels each ran.
KERNEL_LAUNCHES = DEFAULT_REGISTRY.gauge(
    "weed_kernel_launches",
    "CUDA kernel launches by this process's wrappers since they were last "
    "reset (a plain version's run on the CPU is not a launch)",
    ("kernel",),
)


def _publish_kernel_launches() -> None:
    from seaweedfs_tpu_torch import _build

    for name, counter in list(_build.COUNTERS.items()):
        KERNEL_LAUNCHES.set(counter.value, name)


DEFAULT_REGISTRY.add_prerender_hook(_publish_kernel_launches)
TIERED_VOLUMES = DEFAULT_REGISTRY.gauge(
    "weed_tiered_volumes",
    "EC volumes currently holding a remote tier attachment on this node",
    ("server",),
)
REPLICATION_LAG = DEFAULT_REGISTRY.gauge(
    "weed_replication_lag_events",
    "filer mutation events published but not yet consumed by the "
    "replication consumer group (logqueue depth)",
    ("group",),
)
REPLICATION_APPLIED = DEFAULT_REGISTRY.counter(
    "weed_replication_applied_total",
    "replicated filer events applied to the sink cluster",
    ("result",),  # ok | error | skipped
)
ARBITER_BYTES = DEFAULT_REGISTRY.counter(
    "weed_arbiter_bytes_total",
    "background bytes admitted by the bandwidth arbiter, per claimant",
    ("claimant",),  # rebuild | replication | handoff | tier
)
ARBITER_WAIT_SECONDS = DEFAULT_REGISTRY.counter(
    "weed_arbiter_wait_seconds_total",
    "seconds background claimants spent blocked on their share",
    ("claimant",),
)

# --- master push loop and health plane ---------------------------------------
PUSH_LAST_SUCCESS = DEFAULT_REGISTRY.gauge(
    "weed_metrics_push_last_success_unix",
    "unix time of the last successful pushgateway POST",
    ("job",),
)
PUSH_UP = DEFAULT_REGISTRY.gauge(
    "weed_metrics_push_up",
    "1 when the most recent pushgateway POST succeeded, else 0",
    ("job",),
)
PUSH_FAILURES = DEFAULT_REGISTRY.counter(
    "weed_metrics_push_failures_total",
    "pushgateway POSTs that failed",
    ("job",),
)
HEALTH_TRANSITIONS = DEFAULT_REGISTRY.counter(
    "weed_health_transitions_total",
    "node health-state transitions observed by the master, by new state",
    ("state",),
)

# --- cluster telemetry plane (docs/TELEMETRY.md) ----------------------------
# Set by the master's leader-only collector: per-target scrape health
# and the alert rule engine's firing state, re-exported so any external
# scraper of the master inherits cluster aggregation and alerting.
SCRAPE_STALENESS = DEFAULT_REGISTRY.gauge(
    "weed_scrape_staleness_seconds",
    "seconds since the collector last scraped this target successfully",
    ("target",),
)
SCRAPE_UP = DEFAULT_REGISTRY.gauge(
    "weed_scrape_up",
    "1 when the most recent scrape of this target succeeded, else 0",
    ("target",),
)
ALERT_FIRING = DEFAULT_REGISTRY.gauge(
    "weed_alert_firing",
    "1 while this alert rule is firing for this target",
    ("alert", "target"),
)
# Set by the leader's SLO engine (telemetry/slo.py) every collector
# cycle: multi-window burn rate per objective (window: fast | slow) and
# the fraction of the slow window's error budget still unspent.
SLO_BURN_RATE = DEFAULT_REGISTRY.gauge(
    "weed_slo_burn_rate",
    "error-budget burn rate per SLO objective and evaluation window "
    "(1.0 = burning exactly the sustainable budget)",
    ("objective", "window"),
)
SLO_BUDGET_REMAINING = DEFAULT_REGISTRY.gauge(
    "weed_slo_budget_remaining",
    "fraction of the SLO error budget left over the slow window "
    "(1.0 = untouched, 0.0 = fully burned)",
    ("objective",),
)
CAPSULE_CAPTURES = DEFAULT_REGISTRY.counter(
    "weed_capsule_captures_total",
    "incident capsules captured on this node",
    ("trigger",),  # trigger: alert | manual | error
)


# textual push-loop health (gauges can't carry the error STRING): job
# -> {"last_success_unix", "last_error"}
_push_status: dict[str, dict] = {}
_push_status_lock = threading.Lock()


def push_status() -> dict[str, dict]:
    """Per-job push-loop health rows for operator surfaces."""
    with _push_status_lock:
        return {job: dict(row) for job, row in _push_status.items()}


def start_push_loop(
    gateway_url: str,
    job: str,
    interval_sec: float,
    registry: Registry = DEFAULT_REGISTRY,
    stop_event: threading.Event | None = None,
) -> threading.Thread:
    """Push registry text to a pushgateway URL every interval
    (stats/metrics.go LoopPushingMetric; interval and address arrive in
    the master HeartbeatResponse). The thread ends once `stop_event`
    (its `.stop_event`) is set."""
    stop = stop_event or threading.Event()
    with _push_status_lock:
        _push_status[job] = {"last_success_unix": 0.0, "last_error": ""}

    def loop():
        while not stop.is_set():
            try:
                body = registry.render_text().encode()
                req = urllib.request.Request(
                    gateway_url.rstrip("/") + f"/metrics/job/{job}",
                    data=body,
                    method="POST",
                    headers={"Content-Type": "text/plain; version=0.0.4"},
                )
                urllib.request.urlopen(req, timeout=5).read()
                PUSH_LAST_SUCCESS.set(time.time(), job)
                PUSH_UP.set(1.0, job)
                with _push_status_lock:
                    _push_status[job] = {
                        "last_success_unix": round(time.time(), 3),
                        "last_error": "",
                    }
            except OSError as e:
                # a push gateway being down must not hurt the server,
                # but it stays visible: /metrics carries the loop's own
                # health and push_status() keeps the error string
                PUSH_UP.set(0.0, job)
                PUSH_FAILURES.labels(job).inc()
                with _push_status_lock:
                    _push_status[job]["last_error"] = str(e)[:300]
            stop.wait(interval_sec)

    t = threading.Thread(target=loop, daemon=True, name="metrics-push")
    t.stop_event = stop
    t.start()
    return t
