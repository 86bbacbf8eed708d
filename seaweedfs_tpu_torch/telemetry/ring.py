"""Fixed-retention in-process ring TSDB.

One `SeriesRing` per scraped series: a preallocated (time, value) ring
whose capacity IS the retention policy — no compaction, no disk, no
unbounded growth no matter how long the master runs. A `TargetStore`
holds every series scraped from one node plus the scrape-health
bookkeeping (last success, last error, staleness) the alert rules and
/cluster/health read.

Counters are handled reset-aware: `increase()` sums positive adjacent
deltas so a daemon restart (counter back to 0) contributes nothing
instead of a huge negative spike — the classic naive last-minus-first
bug every homegrown scraper ships once.

The port of seaweedfs_tpu/telemetry/ring.py.
"""

from __future__ import annotations

import threading
import time

from seaweedfs_tpu_torch.stats.quantile import histogram_quantile

LabelTuple = tuple[tuple[str, str], ...]
SeriesKey = tuple[str, LabelTuple]


def quantile_from_buckets(
    by_le: dict[float, float], q: float
) -> float | None:
    """histogram_quantile over a {le bound: cumulative count} map (the
    shape bucket_increases returns — possibly pooled across several
    TargetStores by the SLO engine). None when the map saw nothing."""
    if not by_le:
        return None
    bounds = sorted(by_le)
    cum = [by_le[b] for b in bounds]
    # cumulative → per-bucket counts
    counts = [cum[0]] + [
        max(0.0, cum[i] - cum[i - 1]) for i in range(1, len(cum))
    ]
    if sum(counts) <= 0:
        return None
    finite_bounds = [b for b in bounds if b != float("inf")]
    if len(finite_bounds) < len(bounds):
        # fold the +Inf bucket into the overflow slot
        counts = counts[: len(finite_bounds)] + [counts[-1]]
    return histogram_quantile(finite_bounds, counts, q)


class SeriesRing:
    """Preallocated (t, v) ring; append overwrites the oldest sample."""

    __slots__ = ("_t", "_v", "_next", "count", "cap")

    def __init__(self, cap: int = 240):
        self.cap = cap
        self._t = [0.0] * cap
        self._v = [0.0] * cap
        self._next = 0
        self.count = 0

    def append(self, t: float, v: float) -> None:
        i = self._next
        self._t[i] = t
        self._v[i] = v
        self._next = (i + 1) % self.cap
        if self.count < self.cap:
            self.count += 1

    def items(self) -> list[tuple[float, float]]:
        """Samples oldest → newest."""
        if self.count < self.cap:
            return [(self._t[i], self._v[i]) for i in range(self.count)]
        start = self._next
        return [
            (self._t[(start + i) % self.cap], self._v[(start + i) % self.cap])
            for i in range(self.cap)
        ]

    def last(self) -> tuple[float, float] | None:
        if self.count == 0:
            return None
        i = (self._next - 1) % self.cap
        return self._t[i], self._v[i]

    def window(self, window_s: float, now: float | None = None
               ) -> list[tuple[float, float]]:
        """Samples within the trailing window, oldest → newest."""
        now = time.time() if now is None else now
        lo = now - window_s
        return [(t, v) for t, v in self.items() if t >= lo]

    def increase(self, window_s: float, now: float | None = None) -> float:
        """Counter increase over the window: sum of positive adjacent
        deltas (reset-aware). 0.0 with fewer than two samples."""
        pts = self.window(window_s, now)
        total = 0.0
        for (t0, v0), (t1, v1) in zip(pts, pts[1:]):
            if v1 > v0:
                total += v1 - v0
        return total

    def rate(self, window_s: float, now: float | None = None) -> float:
        """Counter per-second rate over the window (increase / span)."""
        pts = self.window(window_s, now)
        if len(pts) < 2:
            return 0.0
        span = pts[-1][0] - pts[0][0]
        if span <= 0:
            return 0.0
        return self.increase(window_s, now) / span


class TargetStore:
    """Every series scraped from one target, plus scrape health.

    `record_scrape` ingests one parsed scrape atomically under the
    store lock; readers (`rate_sum`, `quantile`, health snapshots) take
    the same lock, so a half-ingested scrape is never visible — the
    same snapshot-consistency contract Registry.render_text keeps on
    the producing side."""

    def __init__(self, url: str, kind: str, ring_cap: int = 240):
        self.url = url
        self.kind = kind
        self.ring_cap = ring_cap
        self.series: dict[SeriesKey, SeriesRing] = {}
        self.last_success = 0.0
        self.last_attempt = 0.0
        self.last_error = ""
        self.scrapes = 0
        self.first_seen = time.time()
        self._lock = threading.Lock()

    # ------------------------------------------------------------------
    # ingest
    def record_scrape(self, samples, t: float | None = None) -> None:
        t = time.time() if t is None else t
        with self._lock:
            for name, labels, value in samples:
                key = (name, labels)
                ring = self.series.get(key)
                if ring is None:
                    ring = self.series[key] = SeriesRing(self.ring_cap)
                ring.append(t, value)
            self.last_success = self.last_attempt = t
            self.last_error = ""
            self.scrapes += 1

    def record_failure(self, err: str, t: float | None = None) -> None:
        with self._lock:
            self.last_attempt = time.time() if t is None else t
            self.last_error = err[:300]

    # ------------------------------------------------------------------
    # reads
    def staleness(self, now: float | None = None) -> float:
        """Seconds since the last successful scrape; since first sight
        when none ever succeeded (so a never-up target goes stale too)."""
        now = time.time() if now is None else now
        return now - (self.last_success or self.first_seen)

    def series_count(self) -> int:
        with self._lock:
            return len(self.series)

    def last_value(self, name: str, **labels: str) -> float | None:
        """Newest sample of the series matching name + label SUBSET."""
        want = set(labels.items())
        with self._lock:
            newest: tuple[float, float] | None = None
            for (n, lt), ring in self.series.items():
                if n != name or not want.issubset(lt):
                    continue
                last = ring.last()
                if last is not None and (newest is None or last[0] > newest[0]):
                    newest = last
        return newest[1] if newest else None

    def rate_sum(
        self,
        name: str,
        window_s: float,
        now: float | None = None,
        label_filter=None,
    ) -> float:
        """Per-second rate of a counter family over the window, summed
        across every series of that name (optionally filtered by
        `label_filter(labels_dict) -> bool`)."""
        total = 0.0
        with self._lock:
            for (n, lt), ring in self.series.items():
                if n != name:
                    continue
                if label_filter is not None and not label_filter(dict(lt)):
                    continue
                total += ring.rate(window_s, now)
        return total

    def increase_sum(
        self,
        name: str,
        window_s: float,
        now: float | None = None,
        label_filter=None,
    ) -> float:
        total = 0.0
        with self._lock:
            for (n, lt), ring in self.series.items():
                if n != name:
                    continue
                if label_filter is not None and not label_filter(dict(lt)):
                    continue
                total += ring.increase(window_s, now)
        return total

    def bucket_increases(
        self,
        family: str,
        window_s: float,
        now: float | None = None,
        label_filter=None,
    ) -> dict[float, float]:
        """Windowed increases of a histogram family's `<family>_bucket`
        series, keyed by `le` bound (cumulative, Prometheus-style) and
        aggregated across all non-`le` label splits (optionally
        filtered). The shared primitive under quantile() and the SLO
        engine's latency objectives (telemetry/slo.py): the entry at a
        bound is how many observations landed at-or-under it in the
        window, the `+Inf` entry is the window's total count."""
        bucket_name = family + "_bucket"
        by_le: dict[float, float] = {}
        with self._lock:
            for (n, lt), ring in self.series.items():
                if n != bucket_name:
                    continue
                labels = dict(lt)
                le = labels.pop("le", None)
                if le is None:
                    continue
                if label_filter is not None and not label_filter(labels):
                    continue
                bound = float("inf") if le in ("+Inf", "inf") else float(le)
                by_le[bound] = by_le.get(bound, 0.0) + ring.increase(
                    window_s, now
                )
        return by_le

    def quantile(
        self,
        family: str,
        q: float,
        window_s: float,
        now: float | None = None,
        label_filter=None,
    ) -> float | None:
        """Quantile estimate from a Prometheus histogram family's
        `<family>_bucket` series over the trailing window.

        Buckets arrive CUMULATIVE per scrape; the windowed increase per
        `le` is itself cumulative across les, so adjacent-le differences
        yield the per-bucket counts histogram_quantile wants. Returns
        None when the window saw no observations."""
        return quantile_from_buckets(
            self.bucket_increases(family, window_s, now, label_filter), q
        )

    def dump_window(
        self,
        prefixes: tuple[str, ...],
        window_s: float,
        now: float | None = None,
    ) -> dict[str, list[list[float]]]:
        """Raw [t, v] samples within the trailing window for every
        series whose family name starts with one of `prefixes` —
        the incident capsule's TSDB section (telemetry/capsule.py).
        Keyed by the Prometheus-rendered series identity so the dump
        round-trips through any promtext tooling."""
        out: dict[str, list[list[float]]] = {}
        with self._lock:
            for (n, lt), ring in self.series.items():
                if not n.startswith(prefixes):
                    continue
                pts = ring.window(window_s, now)
                if not pts:
                    continue
                if lt:
                    rendered = ",".join(f'{k}="{v}"' for k, v in lt)
                    key = f"{n}{{{rendered}}}"
                else:
                    key = n
                out[key] = [[round(t, 3), v] for t, v in pts]
        return out

    def health_row(
        self, now: float | None = None, stale_after: float | None = None
    ) -> dict:
        """Operator row. `Up` uses the SAME staleness grace as the
        weed_scrape_up gauge and the alert rule (one transient failed
        scrape must not read DOWN while the alert page stays green) —
        callers pass the collector's stale_after; None falls back to
        the strict last-scrape-succeeded view."""
        now = time.time() if now is None else now
        with self._lock:
            if stale_after is None:
                up = bool(
                    self.last_success
                    and self.last_success >= self.last_attempt
                )
            else:
                up = bool(
                    self.last_success
                    and now - self.last_success < stale_after
                )
            return {
                "Kind": self.kind,
                "Up": up,
                "LastSuccessUnix": round(self.last_success, 3),
                "StalenessSeconds": round(
                    now - (self.last_success or self.first_seen), 3
                ),
                "LastError": self.last_error,
                "Scrapes": self.scrapes,
                "Series": len(self.series),
            }
