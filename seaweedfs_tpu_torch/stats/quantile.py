"""Shared quantile estimators.

One implementation for every consumer that ranks latencies: the bench
stage breakdowns (bench.py `trace` / `migration` / `scrub` configs),
the telemetry plane's ring TSDB (cluster-wide p99 from scraped
histogram buckets), and weedload's log-bucketed latency histograms.
Before this module each site hand-rolled its own `sorted()[int(n*p)]`
with subtly different clamping — the estimators must agree or the
cluster dashboard and the bench lines argue about the same tail.

The port of seaweedfs_tpu/stats/quantile.py: the same estimators, so the
port's tails equal the reference's on the same samples.
"""

from __future__ import annotations


def percentile(values: list[float], p: float) -> float:
    """Nearest-rank percentile of an UNSORTED sample list.

    `p` in [0, 1]. Uses the ceil-of-rank convention (the value at index
    ceil(p*n)-1 of the sorted sample, clamped into range) so p=1.0 is
    the max and p=0.0 the min; matches what bench.py historically
    reported within one rank. Raises ValueError on an empty sample —
    every call site has a real decision to make when there is no data,
    and a silent 0.0 would read as "fast"."""
    if not values:
        raise ValueError("percentile of empty sample")
    if not 0.0 <= p <= 1.0:
        raise ValueError(f"percentile p={p} outside [0, 1]")
    ordered = sorted(values)
    # ceil(p * n) - 1, computed without floats' ceil import
    rank = int(p * len(ordered) + 0.9999999999) - 1
    return ordered[max(0, min(len(ordered) - 1, rank))]


def histogram_quantile(
    bounds: list[float] | tuple[float, ...],
    counts: list[float] | list[int],
    q: float,
) -> float:
    """Prometheus-style quantile from a cumulative-free bucket histogram.

    `bounds[i]` is the inclusive upper bound of bucket i; `counts[i]`
    the number of observations that landed in bucket i (NOT cumulative
    — callers holding Prometheus cumulative buckets take adjacent
    differences first). `counts` may carry one extra overflow bucket
    (observations above the last bound). Linear interpolation inside
    the winning bucket, the same estimate promQL's histogram_quantile
    produces; the overflow bucket reports its lower edge (no upper
    bound to interpolate toward). Returns 0.0 when the histogram is
    empty."""
    if not 0.0 <= q <= 1.0:
        raise ValueError(f"histogram quantile q={q} outside [0, 1]")
    if len(counts) not in (len(bounds), len(bounds) + 1):
        raise ValueError(
            f"counts ({len(counts)}) must match bounds ({len(bounds)}) "
            "or carry one overflow bucket"
        )
    total = sum(counts)
    if total <= 0:
        return 0.0
    target = q * total
    cum = 0.0
    for i, c in enumerate(counts):
        if c <= 0:
            continue
        if cum + c >= target:
            if i >= len(bounds):  # overflow bucket: no upper bound
                return bounds[-1] if bounds else 0.0
            lo = bounds[i - 1] if i > 0 else 0.0
            hi = bounds[i]
            frac = (target - cum) / c
            return lo + (hi - lo) * max(0.0, min(1.0, frac))
        cum += c
    # q == 1.0 with all mass in bounded buckets
    for i in range(len(counts) - 1, -1, -1):
        if counts[i] > 0:
            return bounds[min(i, len(bounds) - 1)]
    return 0.0
