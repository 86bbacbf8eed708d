"""The port's cluster telemetry plane against seaweedfs_tpu's, on the CPU.

tests/test_telemetry.py ported, each case on both packages: the quantile
estimators, the Prometheus text parser, the ring TSDB, the alert state
machine and the render-snapshot regression run the reference's asserts
on each side, and the same seeded inputs (numpy) go through both
packages' functions, whose outputs must be equal: percentiles and
bucket quantiles, parsed samples (of the port's own /metrics exposition
too, `weed_kernel_launches` and exemplars included), ring increases,
rates and quantiles, alert payloads and on_fire rows, and the
collector's health, top, SLO and window payloads under a pinned clock.
Both sides are pure Python on the same floats, so the tolerance is
equality.

End to end, a reference cluster and a port cluster (the port's volume
servers on the cuda backend with device="cpu", the kernels' plain
versions), each a master with its collector on (`telemetry_interval`
1.0 s: the rule set floors staleness to 3 s) and two volume servers in
this process: a killed volume server's `scrape_staleness` fires and
resolves after a restart on its port, through /cluster/alerts,
/cluster/health, the re-exported gauge and the shell, and both sides
pass through the same (rule, target, state) sequence; `cluster.top`
ranks traffic; an announced gateway becomes a scrape target;
/debug/profile; /cluster/register's validation. The command line's
`master` and `server` start with the reference's default
-telemetryInterval and answer /cluster/alerts. The tier scheduler reads
a volume under reads warm through the collector on both packages, and
cold with the collector off. Every wait has a deadline; no fixed sleep
stands in for a condition.
"""

from __future__ import annotations

import contextlib
import http.server
import importlib
import io
import json
import os
import shlex
import signal
import subprocess
import sys
import threading
import time
import urllib.error
import urllib.request

import numpy as np
import pytest

SIDES = ("ref", "port")
PKG = {"ref": "seaweedfs_tpu", "port": "seaweedfs_tpu_torch"}
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def mod(side: str, name: str):
    return importlib.import_module(f"{PKG[side]}.{name}")


def _get_json(url: str, timeout: float = 10.0) -> dict:
    with urllib.request.urlopen(url, timeout=timeout) as r:
        return json.loads(r.read())


def wait_until(pred, what: str, deadline_s: float = 60.0):
    t0 = time.time()
    while time.time() - t0 < deadline_s:
        try:
            out = pred()
            if out:
                return out
        except Exception:  # noqa: BLE001 - not-ready counts as false
            pass
        time.sleep(0.1)
    raise AssertionError(f"timed out waiting for {what}")


# ----------------------------------------------------------------------
# quantile helpers


@pytest.mark.parametrize("side", SIDES)
class TestQuantile:
    def test_percentile_nearest_rank(self, side):
        percentile = mod(side, "stats.quantile").percentile
        vals = list(range(1, 11))
        assert percentile(vals, 0.5) == 5
        assert percentile(vals, 0.0) == 1
        assert percentile(vals, 1.0) == 10
        assert percentile(vals, 0.99) == 10
        assert percentile([7.0], 0.99) == 7.0

    def test_percentile_unsorted_input(self, side):
        assert mod(side, "stats.quantile").percentile([9, 1, 5, 3, 7], 0.5) == 5

    def test_percentile_empty_raises(self, side):
        percentile = mod(side, "stats.quantile").percentile
        with pytest.raises(ValueError):
            percentile([], 0.5)
        with pytest.raises(ValueError):
            percentile([1.0], 1.5)

    def test_histogram_quantile_interpolates(self, side):
        hq = mod(side, "stats.quantile").histogram_quantile
        assert hq([0.1, 0.2, 0.4], [0, 100, 0], 0.5) == pytest.approx(0.15)
        assert hq([0.1, 0.2, 0.4], [0, 100, 0], 1.0) == pytest.approx(0.2)

    def test_histogram_quantile_overflow_bucket(self, side):
        hq = mod(side, "stats.quantile").histogram_quantile
        assert hq([0.1, 0.2], [0, 0, 5], 0.5) == pytest.approx(0.2)

    def test_histogram_quantile_empty_and_validation(self, side):
        hq = mod(side, "stats.quantile").histogram_quantile
        assert hq([0.1], [0], 0.99) == 0.0
        with pytest.raises(ValueError):
            hq([0.1, 0.2], [1], 0.5)


@pytest.mark.parametrize("seed", range(4))
def test_quantiles_equal_the_references(seed):
    qs = [0.0, 0.25, 0.5, 0.9, 0.99, 0.999, 1.0]
    got = {}
    for side in SIDES:
        q = mod(side, "stats.quantile")
        r = np.random.default_rng(seed)
        out = []
        for _ in range(8):
            vals = r.exponential(0.01, int(r.integers(1, 400))).tolist()
            bounds = sorted(set(np.round(r.uniform(1e-4, 1.0, 12), 6).tolist()))
            counts = r.integers(0, 50, len(bounds) + int(r.integers(0, 2))).tolist()
            out.append(([q.percentile(vals, p) for p in qs],
                        [q.histogram_quantile(bounds, counts, p) for p in qs]))
        got[side] = out
    assert got["port"] == got["ref"]


# ----------------------------------------------------------------------
# Prometheus text parser


@pytest.mark.parametrize("side", SIDES)
class TestParse:
    def test_roundtrip_with_registry(self, side):
        Registry = mod(side, "stats.metrics").Registry
        parse = mod(side, "telemetry.parse").parse_prometheus_text
        reg = Registry()
        c = reg.counter("t_total", "help", ("server", "status"))
        c.labels("vol a", "200").inc(3)
        g = reg.gauge("t_gauge", "help")
        g.set(2.5)
        h = reg.histogram("t_hist", "help", buckets=(0.1, 1.0))
        h.observe(0.05)
        h.observe(5.0)
        d = {(n, lt): v for n, lt, v in parse(reg.render_text())}
        assert d[("t_total", (("server", "vol a"), ("status", "200")))] == 3.0
        assert d[("t_gauge", ())] == 2.5
        assert d[("t_hist_bucket", (("le", "0.1"),))] == 1.0
        assert d[("t_hist_bucket", (("le", "+Inf"),))] == 2.0
        assert d[("t_hist_count", ())] == 2.0

    def test_escapes_and_malformed_lines(self, side):
        parse = mod(side, "telemetry.parse").parse_prometheus_text
        text = (
            '# HELP x help text\n'
            '# TYPE x counter\n'
            'x{path="a\\"b\\\\c\\nd"} 1\n'
            'garbage line without value\n'
            'noval \n'
            'y 2.5e-3\n'
            'z +Inf\n'
        )
        samples = parse(text)
        d = {(n, lt): v for n, lt, v in samples}
        assert d[("x", (("path", 'a"b\\c\nd'),))] == 1.0
        assert d[("y", ())] == pytest.approx(0.0025)
        assert d[("z", ())] == float("inf")
        assert len(samples) == 3


def test_port_exposition_parses_as_the_references():
    """The port's own /metrics render (its DEFAULT_REGISTRY, with the
    port-only weed_kernel_launches family, one row a kernel wrapper)
    parses to the same samples under both parsers."""
    import seaweedfs_tpu_torch.ec.codec_cuda  # noqa: F401 - registers the launch counters
    from seaweedfs_tpu_torch.stats.metrics import DEFAULT_REGISTRY, HTTP_REQUEST_HISTOGRAM

    HTTP_REQUEST_HISTOGRAM.observe(0.004, "telemetry-test", "GET")
    HTTP_REQUEST_HISTOGRAM.put_exemplar(0.004, "feedface", "telemetry-test", "GET")
    text = DEFAULT_REGISTRY.render_text()
    assert 'trace_id="feedface"' in text
    got = mod("port", "telemetry.parse").parse_prometheus_text(text)
    assert got == mod("ref", "telemetry.parse").parse_prometheus_text(text)
    kernels = {dict(lt)["kernel"]: v for n, lt, v in got if n == "weed_kernel_launches"}
    assert {"gf_apply", "crc32c_rows", "gf_bits"} <= set(kernels)


@pytest.mark.parametrize("seed", range(3))
def test_seeded_registry_parses_equal(seed):
    """A seeded registry of counters, gauges and histograms (label values
    with quotes, backslashes and newlines; exemplars) rendered by each
    package parses to equal samples on both sides and across sides."""
    texts, parsed = {}, {}
    for side in SIDES:
        metrics = mod(side, "stats.metrics")
        rng = np.random.default_rng(seed)
        reg = metrics.Registry()
        alphabet = list('ab "\\\nz01')
        for f in range(4):
            c = reg.counter(f"s{seed}_c{f}_total", "h", ("k",))
            g = reg.gauge(f"s{seed}_g{f}", "h", ("k",))
            h = reg.histogram(f"s{seed}_h{f}_seconds", "h", ("k",), buckets=(0.01, 0.1, 1.0))
            for _ in range(int(rng.integers(1, 6))):
                label = "".join(rng.choice(alphabet, int(rng.integers(1, 6))))
                c.labels(label).inc(float(rng.integers(1, 100)))
                g.set(float(np.round(rng.normal(), 6)), label)
                v = float(np.round(rng.exponential(0.2), 6))
                h.observe(v, label)
                h.put_exemplar(v, f"{int(rng.integers(1 << 30)):x}", label)
        texts[side] = reg.render_text()
        parsed[side] = {p: mod(p, "telemetry.parse").parse_prometheus_text(texts[side])
                        for p in SIDES}
    assert texts["port"] == texts["ref"]
    for side in SIDES:
        assert parsed[side]["port"] == parsed[side]["ref"]
    assert parsed["port"]["port"]


# ----------------------------------------------------------------------
# ring TSDB


@pytest.mark.parametrize("side", SIDES)
class TestSeriesRing:
    def test_retention_cap(self, side):
        r = mod(side, "telemetry.ring").SeriesRing(cap=4)
        for i in range(10):
            r.append(float(i), float(i * 10))
        assert r.count == 4
        assert [v for _, v in r.items()] == [60.0, 70.0, 80.0, 90.0]
        assert r.last() == (9.0, 90.0)

    def test_increase_is_reset_aware(self, side):
        r = mod(side, "telemetry.ring").SeriesRing(cap=16)
        now = 1000.0
        for i, v in enumerate([10, 30, 50, 0, 3, 7]):
            r.append(now + i, float(v))
        assert r.increase(100.0, now=now + 6) == pytest.approx(47.0)
        assert r.rate(100.0, now=now + 6) == pytest.approx(47.0 / 5.0)

    def test_rate_needs_two_samples(self, side):
        r = mod(side, "telemetry.ring").SeriesRing(cap=4)
        r.append(1.0, 5.0)
        assert r.rate(100.0, now=2.0) == 0.0

    def test_target_store_quantile_from_buckets(self, side):
        ts = mod(side, "telemetry.ring").TargetStore("n1:80", "volume")

        def mk(le, v):
            return ("w_seconds_bucket", (("le", le), ("name", "x")), v)

        ts.record_scrape([mk("0.1", 0), mk("1.0", 0), mk("+Inf", 0)], t=100.0)
        ts.record_scrape([mk("0.1", 0), mk("1.0", 100), mk("+Inf", 100)], t=110.0)
        q = ts.quantile("w_seconds", 0.5, window_s=60.0, now=111.0)
        assert q == pytest.approx(0.55, rel=0.01)
        assert ts.quantile("w_seconds", 0.5, window_s=0.5, now=200.0) is None

    def test_target_store_staleness_and_health(self, side):
        ts = mod(side, "telemetry.ring").TargetStore("n1:80", "volume")
        ts.record_scrape([("up", (), 1.0)], t=100.0)
        assert ts.staleness(now=130.0) == pytest.approx(30.0)
        ts.record_failure("boom", t=140.0)
        row = ts.health_row(now=140.0)
        assert row["LastError"] == "boom"
        assert not row["Up"]
        assert row["Series"] == 1


def _seeded_scrapes(seed: int, n: int = 40):
    """[(t, samples)]: request counters by status (with a reset), a
    latency histogram by plane and a gauge, drawn from `seed`."""
    rng = np.random.default_rng(seed)
    bounds = ("0.005", "0.05", "0.5", "5.0", "+Inf")
    req = {"200": 0.0, "404": 0.0, "500": 0.0, "503": 0.0}
    per_bucket = {p: np.zeros(len(bounds)) for p in ("serve", "scrub", "repair")}
    out, t = [], 1000.0
    for i in range(n):
        t += float(np.round(rng.uniform(0.5, 2.0), 3))
        if i == n // 2:  # a daemon restart: counters back to 0
            req = {k: 0.0 for k in req}
            per_bucket = {p: np.zeros(len(bounds)) for p in per_bucket}
        for k in req:
            req[k] += float(rng.integers(0, 20 if k == "200" else 3))
        for p in per_bucket:
            per_bucket[p] += rng.integers(0, 5, len(bounds))
        samples = [("weed_http_request_total", (("method", "GET"), ("status", k)), v)
                   for k, v in req.items()]
        for p, counts in per_bucket.items():
            for le, v in zip(bounds, np.cumsum(counts).tolist()):
                samples.append(("weed_span_seconds_bucket",
                                (("le", le), ("name", "x"), ("plane", p)), float(v)))
        samples.append(("weed_replication_lag_events", (), float(rng.integers(0, 2000))))
        out.append((t, samples))
    return out


@pytest.mark.parametrize("seed", range(4))
def test_ring_reads_equal_the_references(seed):
    scrapes = _seeded_scrapes(seed)
    now = scrapes[-1][0] + 0.5
    got = {}
    for side in SIDES:
        ring = mod(side, "telemetry.ring")
        ts = ring.TargetStore("n1:8080", "volume", ring_cap=24)
        for t, samples in scrapes:
            ts.record_scrape(samples, t=t)
        rows = []
        for w in (5.0, 20.0, 60.0, 1e6):
            rows.append((
                ts.rate_sum("weed_http_request_total", w, now),
                ts.increase_sum("weed_http_request_total", w, now,
                                label_filter=lambda lt: lt.get("status", "").startswith("5")),
                ts.bucket_increases("weed_span_seconds", w, now),
                [ts.quantile("weed_span_seconds", q, w, now,
                             label_filter=lambda lt: lt.get("plane") == "scrub")
                 for q in (0.5, 0.99, 0.999)],
                ts.dump_window(("weed_http",), w, now),
            ))
        ring_ = ring.SeriesRing(cap=24)
        for t, samples in scrapes:
            ring_.append(t, samples[0][2])
        got[side] = (rows, ts.last_value("weed_replication_lag_events"),
                     ts.health_row(now, stale_after=3.0), ring_.items(),
                     [ring_.increase(w, now) for w in (3.0, 30.0)],
                     [ring_.rate(w, now) for w in (3.0, 30.0)],
                     ring.quantile_from_buckets(rows[-1][2], 0.9))
    assert got["port"] == got["ref"]


# ----------------------------------------------------------------------
# alert state machine


@pytest.mark.parametrize("side", SIDES)
class TestAlertManager:
    def test_pending_firing_resolved_cycle(self, side):
        alerts = mod(side, "telemetry.alerts")
        rule = alerts.AlertRule("r", "critical", for_s=5.0)
        mgr = alerts.AlertManager()
        mgr.evaluate([(rule, "n1", True, 1.0, "d")], now=100.0)
        assert not mgr.firing()
        assert len(mgr.payload()["Pending"]) == 1
        mgr.evaluate([(rule, "n1", True, 2.0, "d")], now=106.0)
        firing = mgr.firing()
        assert len(firing) == 1 and firing[0]["Alert"] == "r"
        ALERT_FIRING = mod(side, "stats.metrics").ALERT_FIRING
        assert ALERT_FIRING.value("r", "n1") == 1.0
        mgr.evaluate([(rule, "n1", False, 0.0, "")], now=110.0)
        assert not mgr.firing()
        assert ALERT_FIRING.value("r", "n1") == 0.0
        hist = mgr.payload()["History"]
        assert len(hist) == 1 and hist[0]["State"] == "resolved"

    def test_absent_pair_resolves(self, side):
        alerts = mod(side, "telemetry.alerts")
        rule = alerts.AlertRule("gone", for_s=0.0)
        mgr = alerts.AlertManager()
        mgr.evaluate([(rule, "n2", True, 1.0, "d")], now=10.0)
        assert mgr.firing()
        mgr.evaluate([], now=20.0)
        assert not mgr.firing()

    def test_flap_does_not_reach_history(self, side):
        alerts = mod(side, "telemetry.alerts")
        rule = alerts.AlertRule("flappy", for_s=60.0)
        mgr = alerts.AlertManager()
        mgr.evaluate([(rule, "n1", True, 1.0, "")], now=0.0)
        mgr.evaluate([(rule, "n1", False, 0.0, "")], now=1.0)
        assert mgr.payload()["History"] == []


@pytest.mark.parametrize("seed", range(4))
def test_alert_sequences_equal_the_references(seed):
    """Seeded condition streams over three rules and three targets: after
    every cycle both managers' payloads, firing lists and on_fire rows
    are equal."""
    got = {}
    for side in SIDES:
        alerts = mod(side, "telemetry.alerts")
        rng = np.random.default_rng(seed)
        rules = [alerts.AlertRule(f"s{seed}-rule{i}", ("warning", "critical")[i % 2],
                                  for_s=float(i * 2)) for i in range(3)]
        fired: list = []
        mgr = alerts.AlertManager(on_fire=fired.append)
        trace = []
        for cycle in range(60):
            conds = []
            for rule in rules:
                for tgt in ("a:1", "b:2", "c:3"):
                    if rng.random() < 0.1:
                        continue  # the pair vanishes this cycle
                    conds.append((rule, tgt, bool(rng.random() < 0.6),
                                  float(np.round(rng.normal(), 4)), f"d{cycle}"))
            mgr.evaluate(conds, now=1000.0 + cycle)
            trace.append((mgr.payload(), mgr.firing()))
        got[side] = (trace, fired)
    assert got["port"] == got["ref"]
    assert got["port"][1], "no alert ever fired"


# ----------------------------------------------------------------------
# stats/metrics: snapshot-consistent rendering


@pytest.mark.parametrize("side", SIDES)
def test_concurrent_mutation_keeps_exposition_consistent(side):
    reg = mod(side, "stats.metrics").Registry()
    parse = mod(side, "telemetry.parse").parse_prometheus_text
    hist = reg.histogram("c_hist", "h", ("k",), buckets=(0.1, 0.5, 1.0))
    ctr = reg.counter("c_total", "h", ("k",))
    stop = threading.Event()

    def hammer():
        i = 0
        while not stop.is_set():
            hist.observe((i % 13) / 10.0, "a")
            hist.observe((i % 7) / 10.0, "b")
            ctr.labels("a").inc()
            i += 1

    threads = [threading.Thread(target=hammer) for _ in range(3)]
    for t in threads:
        t.start()
    try:
        for _ in range(60):
            buckets: dict = {}
            counts: dict = {}
            for name, labels, value in parse(reg.render_text()):
                ld = dict(labels)
                if name == "c_hist_bucket":
                    le = float("inf") if ld["le"] == "+Inf" else float(ld["le"])
                    buckets.setdefault(ld["k"], []).append((le, value))
                elif name == "c_hist_count":
                    counts[ld["k"]] = value
            for k, rows in buckets.items():
                vals = [v for _, v in sorted(rows)]
                assert vals == sorted(vals), (k, vals)
                assert vals[-1] == counts[k], (k, vals, counts[k])
    finally:
        stop.set()
        for t in threads:
            t.join()


# ----------------------------------------------------------------------
# the collector's payloads on the same scrapes, under a pinned clock


class _DN:
    def __init__(self, url, in_flight, depth, volumes):
        self.url, self.in_flight, self.write_queue_depth = url, in_flight, depth
        self.volumes = volumes


class _Info:
    def __init__(self, size, files):
        self.collection, self.size, self.file_count = "c", size, files


class _Topo:
    def __init__(self, nodes):
        self._nodes = nodes

    def data_nodes(self):
        return self._nodes


class _Master:
    host, port, is_leader, repair = "127.0.0.1", 1, True, None

    def __init__(self, nodes):
        self.topology = _Topo(nodes)

    def gateway_registrations(self):
        return {}


@pytest.mark.parametrize("seed", range(3))
def test_collector_payloads_equal_the_references(seed, monkeypatch):
    scrapes = {f"10.0.0.{i}:8080": _seeded_scrapes(seed * 10 + i) for i in range(3)}
    nodes = [_DN(url, i, 2 * i, {i + 1: _Info(1000 * (i + 1), 10 + i)})
             for i, url in enumerate(scrapes)]
    now = max(s[-1][0] for s in scrapes.values()) + 0.5
    monkeypatch.setattr(time, "time", lambda: now)
    got = {}
    for side in SIDES:
        col = mod(side, "telemetry.collector").ClusterCollector(
            _Master(nodes), interval=1.0, slo_fast_s=30.0, slo_slow_s=60.0)
        ring = mod(side, "telemetry.ring")
        for url, rows in scrapes.items():
            ts = col.targets[url] = ring.TargetStore(url, "volume", col.ring_cap)
            for t, samples in rows:
                ts.record_scrape(samples, t=t)
        stale = col.targets["10.0.0.2:8080"]
        stale.last_success = now - 10.0  # past stale_after (3 s)
        col._evaluate(list(col.targets.values()), now)
        health = col.health_payload()
        health.pop("Push")
        got[side] = (col.alerts.payload(), health, col.top_payload(5), col.slo_payload(),
                     col.window_payload(), sorted(col.up_targets()))
    assert got["port"] == got["ref"]
    firing = {(a["Alert"], a["Target"]) for a in got["port"][0]["Firing"]}
    assert ("scrape_staleness", "10.0.0.2:8080") in firing


def test_first_corruption_fires_scrub_corruptions_on_the_port():
    """A repair of a reference fault: the reference's scrub engine creates
    its corruption counter's series at a node's first corruption, so the
    collector's increase() (two samples of a series) never sees it and
    scrub_corruptions stays quiet; the port's engine creates the series
    at 0, so the same first corruption fires the alert."""

    class Store:
        locations = []

    fired = {}
    for side in SIDES:
        node = f"10.8.8.8:{80 + SIDES.index(side)}"
        mod(side, "scrub.engine").ScrubEngine(Store(), interval=0, node_label=node)
        metrics = mod(side, "stats.metrics")
        parse = mod(side, "telemetry.parse").parse_prometheus_text
        col = mod(side, "telemetry.collector").ClusterCollector(_Master([]), interval=1.0)
        ts = col.targets[node] = mod(side, "telemetry.ring").TargetStore(node, "volume")

        def scrape(t):
            ts.record_scrape([r for r in parse(metrics.DEFAULT_REGISTRY.render_text())
                              if r[0] == "weed_scrub_corruptions_found_total"
                              and dict(r[1]).get("server") in (None, node)], t=t)

        scrape(1000.0)
        metrics.SCRUB_CORRUPTIONS.labels(node, "ec").inc(1)
        scrape(1001.0)
        col._evaluate([ts], 1001.5)
        fired[side] = [(a["Alert"], a["Value"]) for a in col.alerts.firing()
                       if a["Target"] == node]
    assert fired == {"ref": [], "port": [("scrub_corruptions", 1.0)]}


# ----------------------------------------------------------------------
# e2e: the acceptance scenario, on a cluster of each package


def _start(side: str, tmp_path_factory):
    kw = dict(ec_codec="cpu") if side == "ref" else dict(ec_codec="cuda", device="cpu")
    dirs = [str(tmp_path_factory.mktemp(f"{side}-tele{i}")) for i in range(2)]
    master, servers = mod(side, "util.availability").start_cluster(
        dirs, master_kwargs={"telemetry_interval": 1.0}, scrub_interval=0.0, **kw)
    return {"master": master, "servers": servers, "dirs": dirs, "kw": kw}


@pytest.fixture(scope="class")
def telemetry_clusters(tmp_path_factory):
    out = {}
    try:
        for side in SIDES:
            out[side] = _start(side, tmp_path_factory)
        yield out
    finally:
        for c in out.values():
            for vs in c["servers"]:
                with contextlib.suppress(Exception):  # a test may have stopped it
                    vs.stop()
            c["master"].stop()


def _shell(side: str, master, line: str) -> str:
    env = mod(side, "shell.command_env").CommandEnv([f"127.0.0.1:{master.port}"])
    out = io.StringIO()
    parts = shlex.split(line)
    mod(side, "shell.commands").COMMANDS[parts[0]].run(env, parts[1:], out)
    return out.getvalue()


class TestClusterTelemetryE2E:
    def _kill_and_restart(self, side, c) -> dict:
        master, servers, dirs = c["master"], c["servers"], c["dirs"]
        m = f"127.0.0.1:{master.port}"
        victim = servers[1]
        victim_url = f"127.0.0.1:{victim.port}"
        ALERT_FIRING = mod(side, "stats.metrics").ALERT_FIRING
        states: list[str] = []

        def observe() -> dict:
            alerts = _get_json(f"http://{m}/cluster/alerts")
            rows = [a for key in ("Firing", "Pending") for a in alerts[key]
                    if a["Alert"] == "scrape_staleness" and a["Target"] == victim_url]
            state = rows[0]["State"] if rows else "ok"
            if not states or states[-1] != state:
                states.append(state)
            return alerts

        def all_up():
            h = _get_json(f"http://{m}/cluster/health")
            rows = h.get("Targets", {})
            return len(rows) >= 3 and all(r["Up"] for r in rows.values()) and h["Cycles"] >= 2

        wait_until(all_up, f"{side}: all targets scraped and up")
        health = _get_json(f"http://{m}/cluster/health")
        assert health["Targets"][victim_url]["Kind"] == "volume"
        observe()
        victim.stop()

        def staleness_firing():
            return any(a["Alert"] == "scrape_staleness" and a["Target"] == victim_url
                       for a in observe()["Firing"])

        wait_until(staleness_firing, f"{side}: staleness alert firing")
        health = _get_json(f"http://{m}/cluster/health")
        assert not health["Targets"][victim_url]["Up"]
        assert health["FiringAlerts"] >= 1
        assert ALERT_FIRING.value("scrape_staleness", victim_url) == 1.0
        text = _shell(side, master, "cluster.alerts")
        assert "FIRING" in text and "scrape_staleness" in text and victim_url in text
        assert "DOWN" in _shell(side, master, "cluster.health")
        firing_row = next(a for a in observe()["Firing"]
                          if a["Alert"] == "scrape_staleness" and a["Target"] == victim_url)

        revived = mod(side, "server.volume_server").VolumeServer(
            [dirs[1]], port=victim.port, master=m, rack="rack1", heartbeat_interval=0.2,
            max_volume_counts=[100], scrub_interval=0.0, **c["kw"])
        servers[1] = revived
        revived.start()

        def resolved():
            alerts = observe()
            still = any(a["Alert"] == "scrape_staleness" and a["Target"] == victim_url
                        for a in alerts["Firing"])
            up = _get_json(f"http://{m}/cluster/health")["Targets"][victim_url]["Up"]
            return not still and up

        wait_until(resolved, f"{side}: staleness alert resolved after restart")
        assert ALERT_FIRING.value("scrape_staleness", victim_url) == 0.0
        hist = [a for a in _get_json(f"http://{m}/cluster/alerts")["History"]
                if a["Alert"] == "scrape_staleness" and a["Target"] == victim_url]
        assert hist
        return {"states": states + [hist[-1]["State"]],
                "row": (sorted(firing_row), firing_row["Severity"]),
                "history_keys": sorted(hist[-1])}

    def test_kill_volume_server_fires_staleness_then_restart_resolves(
            self, telemetry_clusters):
        """Both sides pass the killed holder through the same (rule,
        target, state) sequence: ok, firing, ok, then a resolved row."""
        got = {side: self._kill_and_restart(side, telemetry_clusters[side])
               for side in SIDES}
        assert got["port"] == got["ref"]
        assert got["port"]["states"] == ["ok", "firing", "ok", "resolved"]

    def test_cluster_top_ranks_traffic(self, telemetry_clusters):
        keys = {}
        for side in SIDES:
            master = telemetry_clusters[side]["master"]
            m = f"127.0.0.1:{master.port}"
            for _ in range(30):
                a = _get_json(f"http://{m}/dir/assign")
                urllib.request.urlopen(urllib.request.Request(
                    f"http://{a['url']}/{a['fid']}", data=b"telemetry-top-payload" * 40,
                    method="POST"), timeout=10).close()

            def has_rates(m=m):
                top = _get_json(f"http://{m}/cluster/top?n=5")
                ok = (top.get("Nodes") and any(r["ReqPerSec"] > 0 for r in top["Nodes"])
                      and top.get("Volumes"))
                return top if ok else None

            top = wait_until(has_rates, f"{side}: cluster.top sees traffic")
            assert top["Volumes"][0]["SizeBytes"] > 0
            rates = [r["ReqPerSec"] for r in top["Nodes"]]
            assert rates == sorted(rates, reverse=True)
            text = _shell(side, master, "cluster.top -n 5")
            assert "busiest nodes" in text and "req/s" in text
            keys[side] = (sorted(top), sorted(top["Nodes"][0]), sorted(top["Volumes"][0]))
        assert keys["port"] == keys["ref"]

    def test_gateway_registration_becomes_scrape_target(self, telemetry_clusters):
        """A gateway (here a bare /metrics server) announced through
        telemetry/announce.py is scraped as a target of its kind."""
        kinds = {}
        for side in SIDES:
            master = telemetry_clusters[side]["master"]
            m = f"127.0.0.1:{master.port}"
            registry = mod(side, "stats.metrics").DEFAULT_REGISTRY

            class Metrics(http.server.BaseHTTPRequestHandler):
                def do_GET(self):
                    body = registry.render_text().encode()
                    self.send_response(200 if self.path == "/metrics" else 404)
                    self.send_header("Content-Length", str(len(body)))
                    self.end_headers()
                    self.wfile.write(body)

                def log_message(self, *a):
                    pass

            port = mod(side, "util.availability").free_port()
            srv = http.server.ThreadingHTTPServer(("127.0.0.1", port), Metrics)
            serving = threading.Thread(target=srv.serve_forever, daemon=True)
            serving.start()
            stop = threading.Event()
            addr = f"127.0.0.1:{port}"
            loop = mod(side, "telemetry.announce").start_announce_loop(
                "filer", addr, [m], interval=0.2, stop_event=stop)
            try:
                def scraped():
                    row = _get_json(f"http://{m}/cluster/health")["Targets"].get(addr)
                    return row if row and row["Kind"] == "filer" and row["Up"] else None

                row = wait_until(scraped, f"{side}: gateway registered and scraped")
                kinds[side] = (row["Kind"], sorted(row), master.gateway_registrations()[addr]
                               ["kind"])
            finally:
                stop.set()
                loop.join(10)
                srv.shutdown()
                srv.server_close()
                serving.join(10)
        assert kinds["port"] == kinds["ref"]

    def test_debug_profile_over_http(self, telemetry_clusters):
        for side in SIDES:
            c = telemetry_clusters[side]
            vport = c["servers"][0].port
            payload = _get_json(f"http://127.0.0.1:{vport}/debug/profile?seconds=0.4",
                                timeout=15)
            assert payload["samples"] > 0
            assert any(";" in s for s in payload["stacks"])
            with urllib.request.urlopen(
                    f"http://127.0.0.1:{vport}/debug/profile?seconds=0.2&fmt=folded",
                    timeout=15) as r:
                body = r.read().decode()
                assert r.headers["Content-Type"].startswith("text/plain")
            _stack, _, count = body.splitlines()[0].rpartition(" ")
            assert int(count) >= 1
            text = _shell(side, c["master"],
                          f"profile.capture -node 127.0.0.1:{vport} -seconds 0.3")
            assert "sample(s)" in text

    def test_register_endpoint_validates(self, telemetry_clusters):
        for side in SIDES:
            m = f"127.0.0.1:{telemetry_clusters[side]['master'].port}"
            with pytest.raises(urllib.error.HTTPError) as ei:
                urllib.request.urlopen(f"http://{m}/cluster/register?kind=s3", timeout=5)
            assert ei.value.code == 400

    def test_capsule_surface_on_every_daemon(self, telemetry_clusters, tmp_path):
        """/capsule/capture, /capsule/list and /capsule/get on a volume
        server and a master of each package, and `capsule.capture` and
        `capsule.collect` through the shell: the manifests' keys and file
        lists are equal across packages (the master's capsule has the
        leader-only tsdb and cluster sections), and the traversal guard
        answers 404. On the port every /capsule/* request to a volume
        server is handed off by the C serving loop to a thread."""
        got = {}
        for side in SIDES:
            capsule = mod(side, "telemetry.capsule")
            capsule.set_dir(str(tmp_path / side))
            c = telemetry_clusters[side]
            vol = f"127.0.0.1:{c['servers'][0].port}"
            mst = f"127.0.0.1:{c['master'].port}"
            try:
                stats0 = _get_json(f"http://{vol}/status").get("ServeStats") or {}
                manifests = {}
                for role, url in (("volume", vol), ("master", mst)):
                    man = _get_json(f"http://{url}/capsule/capture?reason=e2e%20{role}")
                    listed = _get_json(f"http://{url}/capsule/list")["Capsules"]
                    assert man["Id"] in [m["Id"] for m in listed]
                    body = urllib.request.urlopen(
                        f"http://{url}/capsule/get?id={man['Id']}&file=MANIFEST.json",
                        timeout=10).read()
                    assert json.loads(body) == man
                    with pytest.raises(urllib.error.HTTPError) as ei:
                        urllib.request.urlopen(
                            f"http://{url}/capsule/get?id=../x&file=MANIFEST.json", timeout=10)
                    assert ei.value.code == 404
                    manifests[role] = (sorted(man), man["Trigger"],
                                       sorted(f["Name"] for f in man["Files"]),
                                       all(f["Ok"] for f in man["Files"]))
                stats1 = _get_json(f"http://{vol}/status").get("ServeStats") or {}
                captured = _shell(side, c["master"], "capsule.capture -reason shellcap")
                collected = _shell(side, c["master"], "capsule.collect -reason shellcap -json")
                nodes = json.loads(collected)["Nodes"]
                assert captured.count("captured") == len(nodes) >= 3
                assert all(n["Capsule"] and n["Trigger"] == "manual" for n in nodes), nodes
                got[side] = (manifests, sorted(nodes[0]))
            finally:
                capsule.set_dir("")
            if side == "port":
                assert stats1.get("handoffs", 0) > stats0.get("handoffs", 0), (stats0, stats1)
        assert got["port"] == got["ref"]
        assert {"tsdb.json", "cluster.json"} <= set(got["port"][0]["master"][2])

    def test_slo_payload_keys_and_planes(self, telemetry_clusters):
        """/cluster/slo through the shell's -json: the same objectives,
        planes and scorecard keys on both sides."""
        got = {}
        for side in SIDES:
            master = telemetry_clusters[side]["master"]
            snap = json.loads(_shell(side, master, "cluster.slo -json"))
            got[side] = (sorted(snap), [(o["Objective"], o["Plane"], sorted(o))
                                        for o in snap["Objectives"]],
                         sorted(snap["Scorecard"]))
        assert got["port"] == got["ref"]
        assert {"scrub", "repair", "tier", "serve"} == {p for _, p, _ in got["port"][1]}


# ----------------------------------------------------------------------
# the command line's daemons with the reference's default flags


def handles_sigterm(pid: int) -> bool:
    """True once the process has a SIGTERM handler (its SigCgt mask in
    /proc): a daemon installs it after start(), so a SIGTERM sent before
    then ends the process without its stop()."""
    with open(f"/proc/{pid}/status") as f:
        mask = next(line for line in f if line.startswith("SigCgt:")).split()[1]
    return bool(int(mask, 16) & (1 << (signal.SIGTERM - 1)))


def _spawn(*args):
    env = dict(os.environ, WEED_EC_CODEC="cpu")
    return subprocess.Popen([sys.executable, "-m", "seaweedfs_tpu_torch", *args], env=env,
                            cwd=REPO, stdout=subprocess.PIPE, stderr=subprocess.STDOUT)


@pytest.mark.parametrize("daemon", ["master", "server"])
def test_daemon_with_default_flags_runs_the_collector(daemon, tmp_path):
    """`master` and `server` with no -telemetryInterval start (the
    reference's default, 10 s) and answer /cluster/alerts and
    /cluster/health with the collector's payloads; SIGTERM ends them
    with exit code 0."""
    from seaweedfs_tpu_torch.util.availability import free_port

    mport = free_port()
    if daemon == "master":
        proc = _spawn("master", "-port", str(mport))
    else:
        proc = _spawn("server", "-dir", str(tmp_path), "-master.port", str(mport),
                      "-volume.port", str(free_port()), "-ec.codec", "cpu")
    try:
        alerts = wait_until(lambda: _get_json(f"http://127.0.0.1:{mport}/cluster/alerts",
                                              timeout=2), f"{daemon}: /cluster/alerts")
        assert "Disabled" not in alerts and sorted(alerts) == ["Firing", "History", "Pending"]
        health = _get_json(f"http://127.0.0.1:{mport}/cluster/health")
        assert health["IntervalSeconds"] == 10.0 and health["IsLeader"]
        assert "Disabled" not in _get_json(f"http://127.0.0.1:{mport}/cluster/slo")
        wait_until(lambda: handles_sigterm(proc.pid), f"{daemon}: its SIGTERM handler")
    finally:
        proc.send_signal(signal.SIGTERM)
        try:
            out, _ = proc.communicate(timeout=30)
        except subprocess.TimeoutExpired:
            proc.kill()
            raise
    assert proc.returncode == 0, out[-2000:]


def test_workers_lead_answers_metrics_and_each_process_its_capsules(tmp_path):
    """A `volume -workers 3` group on one public port (SO_REUSEPORT), as
    the collector scrapes it: every /metrics answer comes from the lead
    (the workers proxy it, so the counters are the lead's alone: its
    `server="volume"` rows, never a worker's), while /capsule/capture is
    answered by whichever process accepted the connection, the lead or a
    worker (`#w` in the manifest's node), as the reference's group does.
    The master scrapes the group as one target."""
    import socket

    from seaweedfs_tpu_torch.util.availability import free_port

    rng = np.random.default_rng(os.getpid())
    for _ in range(200):  # odd, with its internal ports below the ephemeral range
        vport = 45537 + 2 * int(rng.integers((52767 - 45537) // 2))
        try:
            for q in (vport, vport + 10000, vport - 20000):
                with socket.socket() as sock:
                    sock.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
                    sock.bind(("127.0.0.1", q))
            break
        except OSError:
            continue
    mport = free_port()
    procs = [_spawn("master", "-port", str(mport), "-telemetryInterval", "1")]
    try:
        wait_until(lambda: _get_json(f"http://127.0.0.1:{mport}/cluster/status", timeout=2),
                   "the master")
        procs.append(_spawn("volume", "-port", str(vport), "-dir", str(tmp_path), "-max", "8",
                            "-mserver", f"127.0.0.1:{mport}", "-workers", "3",
                            "-ec.codec", "cpu"))

        def listeners() -> int:
            with open("/proc/net/tcp") as f:
                rows = [line.split() for line in f.readlines()[1:]]
            return sum(1 for r in rows
                       if r[3] == "0A" and int(r[1].rsplit(":", 1)[1], 16) == vport)

        wait_until(lambda: listeners() == 3, "three listeners on the shared port", 120)
        # one request on the lead's own (internal) listener, so that its
        # request counter has a row before the first scrape
        _get_json(f"http://127.0.0.1:{vport - 20000}/status")
        parse = mod("port", "telemetry.parse").parse_prometheus_text
        nodes, answers = set(), []
        for _ in range(24):
            text = urllib.request.urlopen(f"http://127.0.0.1:{vport}/metrics",
                                          timeout=10).read().decode()
            answers.append({dict(lt)["server"] for n, lt, _ in parse(text)
                            if n == "weed_http_request_total" and dict(lt).get("server")})
            man = _get_json(f"http://127.0.0.1:{vport}/capsule/capture?reason=workers")
            nodes.add(man["Node"])
        assert all(a == {"volume"} for a in answers), answers
        assert any("#w" in n for n in nodes), nodes

        def scraped():
            row = _get_json(f"http://127.0.0.1:{mport}/cluster/health")["Targets"].get(
                f"127.0.0.1:{vport}")
            return row if row and row["Up"] and row["Kind"] == "volume" else None

        wait_until(scraped, "the group scraped as one volume target")
        for p in procs:
            wait_until(lambda p=p: handles_sigterm(p.pid), "the daemons' SIGTERM handlers")
    finally:
        for p in procs[::-1]:
            p.send_signal(signal.SIGTERM)
        for p in procs[::-1]:
            try:
                p.communicate(timeout=60)
            except subprocess.TimeoutExpired:
                p.kill()
                p.communicate()
    assert [p.returncode for p in procs] == [0, 0]


# ----------------------------------------------------------------------
# the tier scheduler's temperature reads the collector


@pytest.mark.parametrize("telemetry", [1.0, 0.0], ids=["collector-on", "collector-off"])
def test_tier_read_rate_follows_the_collector(telemetry, tmp_path):
    """A volume under reads reads warm through the master's collector on
    both packages (read_rate > 0), and cold (0.0) with it off."""
    rates = {}
    for side in SIDES:
        kw = dict(ec_codec="cpu") if side == "ref" else dict(ec_codec="cuda", device="cpu")
        (tmp_path / side).mkdir()
        master, servers = mod(side, "util.availability").start_cluster(
            [str(tmp_path / side)], scrub_interval=0.0,
            master_kwargs={"telemetry_interval": telemetry, "tier_interval": 3600.0}, **kw)
        try:
            m = f"127.0.0.1:{master.port}"
            a = _get_json(f"http://{m}/dir/assign")
            urllib.request.urlopen(urllib.request.Request(
                f"http://{a['url']}/{a['fid']}", data=b"warm" * 100, method="POST"),
                timeout=10).close()
            vid = int(a["fid"].split(",")[0])
            stop = threading.Event()
            reads = []

            def reader():
                while not stop.is_set():
                    with urllib.request.urlopen(f"http://{a['url']}/{a['fid']}",
                                                timeout=10) as r:
                        reads.append(r.read())
                    stop.wait(0.02)

            t = threading.Thread(target=reader, daemon=True)
            t.start()
            try:
                if telemetry:
                    rates[side] = wait_until(lambda: master.tier.read_rate(vid),
                                             f"{side}: read_rate of volume {vid} above 0")
                else:
                    wait_until(lambda: len(reads) >= 20, f"{side}: 20 reads")
                    rates[side] = master.tier.read_rate(vid)
            finally:
                stop.set()
                t.join(15)
        finally:
            for vs in servers:
                vs.stop()
            master.stop()
    if telemetry:
        assert all(isinstance(r, float) and r > 0 for r in rates.values()), rates
    else:
        assert rates == {"ref": 0.0, "port": 0.0}


def test_chip_smoke_telemetry_phase_on_the_cpu(tmp_path):
    """chip_smoke.py's telemetry phase at 32 MiB on the host codec: the
    healthy and the degraded weedload runs without errors or a card
    library in a worker, the killed holder's staleness alert firing and
    resolving, and every process ending with 0."""
    sys.path.insert(0, REPO)
    import chip_smoke

    runs = chip_smoke.run_telemetry_phase(str(tmp_path), 32 << 20, 0, device="cpu",
                                          card="cpu")
    tele = runs["tele"]
    assert tele["degraded"]["errors"] == 0 and tele["degraded"]["ops"] > 0
    assert all(tele["healthy"][m]["errors"] == 0 for m in ("put", "get"))
    assert tele["fire_s"] <= tele["stale_after"] + 2 * tele["cycle_s"]
    assert runs["tele_degraded"]["keys"] > 0
