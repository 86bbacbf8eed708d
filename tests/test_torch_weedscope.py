"""The port's weedscope plane against seaweedfs_tpu's, on the CPU.

tests/test_weedscope.py ported whole, each case on both packages: the
SLO engine's measurement math (availability excluding client-attributable
503/504, latency from pooled bucket increases, the plane filter), its
multi-window burn state machine and hysteresis, AlertManager's on_fire
edge hook and bounded history, the blackbox flight recorder, exemplars,
incident capsules (durability, retention, the path-traversal guard, the
auto-capture cooldown and kill switch) and the collector's dead-node
TTL. Beyond the reference's asserts, the same seeded inputs (numpy) go
through both packages and their outputs must be equal: SLO burn rates,
verdicts, exported gauges and payload() dicts; AlertManager rows and
hook calls; blackbox snapshots; and a capsule's manifest keys and file
list. Both sides are pure Python on the same floats, so the tolerance
is equality.
"""

from __future__ import annotations

import importlib
import json
import os
import time

import numpy as np
import pytest

SIDES = ("ref", "port")
PKG = {"ref": "seaweedfs_tpu", "port": "seaweedfs_tpu_torch"}


def mod(side: str, name: str):
    return importlib.import_module(f"{PKG[side]}.{name}")


def _scrape(ts, t: float, rows):
    """rows: [(name, {labels}, value), ...]"""
    ts.record_scrape([(n, tuple(sorted(labels.items())), v) for n, labels, v in rows], t)


# ----------------------------------------------------------------------
# SLO engine: measurement math against a real TargetStore


@pytest.mark.parametrize("side", SIDES)
class TestSLOMeasurement:
    def test_availability_excludes_client_attributable_5xx(self, side):
        slo = mod(side, "telemetry.slo")
        ts = mod(side, "telemetry.ring").TargetStore("n1:8080", "volume")
        fam = "weed_http_request_total"
        _scrape(ts, 100.0, [(fam, {"status": "200"}, 100.0), (fam, {"status": "503"}, 50.0),
                            (fam, {"status": "500"}, 0.0)])
        _scrape(ts, 160.0, [(fam, {"status": "200"}, 200.0), (fam, {"status": "503"}, 150.0),
                            (fam, {"status": "500"}, 1.0)])
        obj = slo.SLOObjective("avail", "availability", 0.999, family=fam)
        eng = slo.SLOEngine(objectives=[obj], fast_s=100.0, slow_s=100.0)
        assert eng._bad_total(obj, [ts], 100.0, 170.0) == (1.0, 201.0)

    def test_latency_counts_bad_above_threshold_bucket(self, side):
        slo = mod(side, "telemetry.slo")
        ts = mod(side, "telemetry.ring").TargetStore("n1:8080", "volume")
        b = "weed_http_request_seconds_bucket"
        _scrape(ts, 100.0, [(b, {"le": "0.1"}, 10.0), (b, {"le": "1.0"}, 10.0),
                            (b, {"le": "+Inf"}, 10.0)])
        _scrape(ts, 160.0, [(b, {"le": "0.1"}, 10.0), (b, {"le": "1.0"}, 15.0),
                            (b, {"le": "+Inf"}, 20.0)])
        obj = slo.SLOObjective("lat", "latency", 0.99, family="weed_http_request_seconds",
                               threshold_s=0.5)
        eng = slo.SLOEngine(objectives=[obj])
        assert eng._bad_total(obj, [ts], 100.0, 170.0) == (5.0, 10.0)

    def test_latency_plane_filter(self, side):
        slo = mod(side, "telemetry.slo")
        ts = mod(side, "telemetry.ring").TargetStore("n1:8080", "volume")
        b = "weed_span_seconds_bucket"
        _scrape(ts, 100.0, [(b, {"le": "+Inf", "plane": "serve"}, 0.0),
                            (b, {"le": "+Inf", "plane": "scrub"}, 0.0)])
        _scrape(ts, 160.0, [(b, {"le": "+Inf", "plane": "serve"}, 100.0),
                            (b, {"le": "+Inf", "plane": "scrub"}, 7.0)])
        obj = slo.SLOObjective("scrub-lat", "latency", 0.95, plane="scrub",
                               family="weed_span_seconds", threshold_s=3.0)
        eng = slo.SLOEngine(objectives=[obj])
        assert eng._pooled_buckets(obj, [ts], 100.0, 170.0)[float("inf")] == 7.0


# ----------------------------------------------------------------------
# SLO engine: multi-window state machine (stub targets drive exact burns)


class _StubTarget:
    kind = "volume"

    def __init__(self, by_window):
        self.by_window = by_window  # {window_s: (bad, total)}

    def increase_sum(self, name, window_s, now=None, label_filter=None):
        bad, total = self.by_window[window_s]
        return bad if label_filter is not None else total

    def bucket_increases(self, family, window_s, now=None, label_filter=None):
        return {}


def _engine(side):
    slo = mod(side, "telemetry.slo")
    avail = slo.SLOObjective("avail", "availability", 0.9, family="weed_http_request_total")
    return slo.SLOEngine(objectives=[avail], fast_s=60.0, slow_s=600.0, burn_threshold=1.0,
                         resolve_factor=0.5)


def _active(side, conds):
    [(rule, target, active, _v, _d)] = conds
    assert rule is mod(side, "telemetry.slo").RULE_SLO_BURN and target == "avail"
    return active


@pytest.mark.parametrize("side", SIDES)
class TestSLOBurnStateMachine:
    def test_fast_only_burst_does_not_fire(self, side):
        eng = _engine(side)
        tgt = _StubTarget({60.0: (10.0, 20.0), 600.0: (10.0, 10000.0)})
        assert not _active(side, eng.evaluate([tgt], now=1000.0))
        assert eng.payload()["Breaching"] == []

    def test_both_windows_burning_fires_and_exports_gauges(self, side):
        metrics = mod(side, "stats.metrics")
        eng = _engine(side)
        tgt = _StubTarget({60.0: (10.0, 20.0), 600.0: (300.0, 1000.0)})
        assert _active(side, eng.evaluate([tgt], now=1000.0))
        assert eng.payload()["Breaching"] == ["avail"]
        assert metrics.SLO_BURN_RATE.value("avail", "fast") == 5.0
        assert metrics.SLO_BURN_RATE.value("avail", "slow") == 3.0
        assert metrics.SLO_BUDGET_REMAINING.value("avail") == 0.0

    def test_resolve_hysteresis(self, side):
        eng = _engine(side)
        burning = _StubTarget({60.0: (10.0, 20.0), 600.0: (300.0, 1000.0)})
        assert _active(side, eng.evaluate([burning], now=1000.0))
        warm = _StubTarget({60.0: (8.0, 100.0), 600.0: (10.0, 10000.0)})
        assert _active(side, eng.evaluate([warm], now=1060.0))
        cold = _StubTarget({60.0: (1.0, 100.0), 600.0: (10.0, 10000.0)})
        assert not _active(side, eng.evaluate([cold], now=1120.0))
        assert eng.payload()["Breaching"] == []
        assert not _active(side, eng.evaluate([warm], now=1180.0))


@pytest.mark.parametrize("seed", range(4))
def test_slo_burns_equal_the_references(seed):
    """Seeded (bad, total) streams through each package's engine with the
    default objectives: every cycle's conditions, payload(), gauges and
    the scorecard over real TargetStores are equal."""
    got = {}
    for side in SIDES:
        slo, metrics = mod(side, "telemetry.slo"), mod(side, "stats.metrics")
        rng = np.random.default_rng(seed)
        eng = slo.SLOEngine(fast_s=60.0, slow_s=600.0, burn_threshold=1.0)
        trace = []
        for cycle in range(30):
            total_f = float(rng.integers(1, 200))
            total_s = total_f * float(rng.integers(1, 20))
            tgt = _StubTarget({60.0: (float(rng.integers(0, 4)), total_f),
                               600.0: (float(rng.integers(0, 40)), total_s)})
            conds = eng.evaluate([tgt], now=1000.0 + 60.0 * cycle)
            trace.append(([(r.name, t, a, v, d) for r, t, a, v, d in conds], eng.payload(),
                          [metrics.SLO_BURN_RATE.value(o.name, w)
                           for o in eng.objectives for w in ("fast", "slow")]))
        ts = mod(side, "telemetry.ring").TargetStore("n1:8080", "volume")
        t = 0.0
        for i in range(12):
            t += 5.0
            _scrape(ts, t, [
                ("weed_http_request_total", {"status": "200"}, 50.0 * i),
                ("weed_http_request_total", {"status": "500"}, float(i // 3)),
                ("weed_retry_total", {}, float(i)),
                ("weed_time_to_repair_seconds_sum", {"kind": "ec_rebuild"}, 4.0 * i),
                ("weed_time_to_repair_seconds_count", {"kind": "ec_rebuild"}, float(i)),
                ("weed_http_request_seconds_bucket", {"le": "0.1"}, 40.0 * i),
                ("weed_http_request_seconds_bucket", {"le": "+Inf"}, 50.0 * i),
            ])
        got[side] = (trace, eng.scorecard([ts], now=t))
    assert got["port"] == got["ref"]


# ----------------------------------------------------------------------
# AlertManager: on_fire edge hook + bounded history


@pytest.mark.parametrize("side", SIDES)
class TestAlertManagerScope:
    def test_on_fire_fires_only_on_edge(self, side):
        alerts = mod(side, "telemetry.alerts")
        rows = []
        rule = alerts.AlertRule("edge", "critical", for_s=0.0)
        mgr = alerts.AlertManager(on_fire=rows.append)
        mgr.evaluate([(rule, "t1", True, 1.0, "d")], now=10.0)
        assert len(rows) == 1 and rows[0]["Alert"] == "edge"
        mgr.evaluate([(rule, "t1", True, 2.0, "d")], now=11.0)
        assert len(rows) == 1
        mgr.evaluate([(rule, "t1", False, 0.0, "")], now=12.0)
        mgr.evaluate([(rule, "t1", True, 3.0, "d")], now=13.0)
        assert len(rows) == 2

    def test_on_fire_exception_never_breaks_evaluation(self, side):
        alerts = mod(side, "telemetry.alerts")
        rule = alerts.AlertRule("boom", for_s=0.0)

        def hook(_row):
            raise RuntimeError("capture exploded")

        mgr = alerts.AlertManager(on_fire=hook)
        mgr.evaluate([(rule, "t1", True, 1.0, "d")], now=10.0)
        assert mgr.firing()

    def test_history_stays_bounded_under_flapping(self, side):
        alerts = mod(side, "telemetry.alerts")
        rule = alerts.AlertRule("flappy", for_s=0.0)
        mgr = alerts.AlertManager()
        for i in range(200):
            mgr.evaluate([(rule, "t1", True, 1.0, "d")], now=float(i))
            mgr.evaluate([(rule, "t1", False, 0.0, "")], now=i + 0.5)
        assert len(mgr._history) <= 128
        assert len(mgr.payload()["History"]) <= 32
        assert ("flappy", "t1") not in mod(side, "stats.metrics").ALERT_FIRING._values


def test_flapping_history_equals_the_references():
    got = {}
    for side in SIDES:
        alerts = mod(side, "telemetry.alerts")
        rule = alerts.AlertRule("flappy-eq", for_s=0.0)
        rows = []
        mgr = alerts.AlertManager(on_fire=rows.append)
        for i in range(200):
            mgr.evaluate([(rule, "t1", True, 1.0, "d")], now=float(i))
            mgr.evaluate([(rule, "t1", False, 0.0, "")], now=i + 0.5)
        got[side] = (list(mgr._history), mgr.payload(), rows)
    assert got["port"] == got["ref"]


# ----------------------------------------------------------------------
# blackbox flight recorder: tail-biased retention


@pytest.mark.parametrize("side", SIDES)
class TestBlackboxRetention:
    def test_tail_bias_and_ok_sampling(self, side):
        blackbox = mod(side, "trace.blackbox")
        blackbox.reset()
        rec = blackbox.recorder("test", "n1")
        ok_every = blackbox.snapshot(0)["ok_every"]
        for _ in range(2 * ok_every):
            rec("GET", "", "serve", 200, 0.001, 10, "p", 0, None)
        rec("GET", "t-err", "serve", 404, 0.001, 0, "p", 0, None)
        rec("GET", "t-slow", "serve", 200, 0.5, 10, "p", 0, None)
        rec("GET", "t-retry", "serve", 200, 0.001, 10, "p", blackbox.FLAG_RETRY, None)
        snap = blackbox.snapshot(64)
        assert snap["tail_recorded"] == 3
        assert snap["ok_recorded"] == 2
        by_trace = {r["trace"]: r for r in snap["tail"]}
        assert by_trace["t-err"]["status"] == 404
        assert by_trace["t-slow"]["dur_ms"] == 500.0
        assert by_trace["t-retry"]["flags"] == ["retry"]
        assert all(r["name"] == "test.GET" for r in snap["tail"])

    def test_kill_switch_drops_records(self, side):
        blackbox = mod(side, "trace.blackbox")
        blackbox.reset()
        rec = blackbox.recorder("test", "n1")
        blackbox.set_enabled(False)
        try:
            rec("GET", "t", "serve", 500, 1.0, 0, "p", 0, None)
            snap = blackbox.snapshot(8)
            assert snap["enabled"] is False
            assert snap["tail_recorded"] == 0
        finally:
            blackbox.set_enabled(True)

    def test_stage_dict_rides_the_record(self, side):
        blackbox = mod(side, "trace.blackbox")
        blackbox.reset()
        rec = blackbox.recorder("volume", "n1")
        rec("GET", "tid", "serve", 404, 0.2, 0, "p", 0,
            {"parse": 0.001, "resolve": 0.002, "send": 0.003})
        [row] = blackbox.snapshot(8)["tail"]
        assert set(row["stages_ms"]) == {"parse", "resolve", "send"}

    def test_request_flags(self, side):
        blackbox = mod(side, "trace.blackbox")
        assert blackbox.request_flags({"x-weed-retry": "1"}, 200) == blackbox.FLAG_RETRY
        assert (blackbox.request_flags({"x-weed-hedge": "1"}, 503)
                == blackbox.FLAG_HEDGE | blackbox.FLAG_SHED)
        assert blackbox.request_flags({}, 504) == blackbox.FLAG_DEADLINE


@pytest.mark.parametrize("seed", range(2))
def test_blackbox_snapshots_equal_the_references(seed):
    """The same seeded wide-events through each package's recorder give
    equal tail rings (errors, slow and flagged records), each record's
    wall-clock stamp `t` aside. The OK ring samples 1 in `ok_every` by a
    process-wide counter whose phase reset() keeps, so the two sides'
    OK counts may differ by one and are checked for that alone."""
    got, oks = {}, {}
    for side in SIDES:
        blackbox = mod(side, "trace.blackbox")
        blackbox.reset()
        rec = blackbox.recorder("volume", "n1")
        rng = np.random.default_rng(seed)
        for i in range(300):
            status = int(rng.choice([200, 200, 200, 206, 304, 404, 500, 503]))
            rec("GET", f"t{i}" if rng.random() < 0.5 else "", "serve", status,
                float(np.round(rng.exponential(0.05), 6)), int(rng.integers(0, 4096)), "p",
                int(rng.integers(0, 4)), None)
        snap = blackbox.snapshot(128)
        oks[side] = (snap.pop("ok_recorded"), [r["status"] for r in snap.pop("ok")])
        snap["tail"] = [{k: v for k, v in r.items() if k != "t"} for r in snap["tail"]]
        got[side] = snap
    assert got["port"] == got["ref"] and got["port"]["tail"]
    assert abs(oks["port"][0] - oks["ref"][0]) <= 1 and oks["port"][0] >= 1
    assert all(st < 400 for side in SIDES for st in oks[side][1])


# ----------------------------------------------------------------------
# exemplars: render + parse round trip


@pytest.mark.parametrize("side", SIDES)
class TestExemplars:
    def test_render_and_parse_round_trip(self, side):
        metrics = mod(side, "stats.metrics")
        parse = mod(side, "telemetry.parse").parse_prometheus_text
        reg = metrics.Registry()
        hist = reg.histogram("x_seconds", "h", ("k",), buckets=(0.1, 1.0))
        hist.observe(0.05, "a")
        hist.put_exemplar(0.05, "traceabc", "a")
        text = reg.render_text()
        assert '# {trace_id="traceabc"}' in text
        buckets = {dict(lt)["le"]: v for n, lt, v in parse(text) if n == "x_seconds_bucket"}
        assert buckets == {"0.1": 1.0, "1.0": 1.0, "+Inf": 1.0}

    def test_kill_switch_reverts_to_plain_exposition(self, side):
        metrics = mod(side, "stats.metrics")
        reg = metrics.Registry()
        hist = reg.histogram("y_seconds", "h", (), buckets=(1.0,))
        hist.observe(0.5)
        hist.put_exemplar(0.5, "tid")
        metrics.set_exemplars_enabled(False)
        try:
            assert "trace_id" not in reg.render_text()
        finally:
            metrics.set_exemplars_enabled(True)
        assert "trace_id" in reg.render_text()


# ----------------------------------------------------------------------
# incident capsules: durability, retention, traversal guard


@pytest.mark.parametrize("side", SIDES)
class TestCapsules:
    def test_capture_is_durable_and_manifest_complete(self, side, tmp_path):
        capsule = mod(side, "telemetry.capsule")
        man = capsule.capture("unit test!", node="n1:80", root=str(tmp_path))
        assert man["Node"] == "n1:80" and man["Trigger"] == "manual"
        cap_dir = tmp_path / man["Id"]
        assert (cap_dir / "MANIFEST.json").exists()
        names = {f["Name"] for f in man["Files"]}
        assert {"blackbox.json", "traces.json", "profile.txt", "metrics.txt"} <= names
        for f in man["Files"]:
            if f["Ok"]:
                assert (cap_dir / f["Name"]).exists()
        [listed] = [c for c in capsule.list_capsules(root=str(tmp_path))
                    if c["Id"] == man["Id"]]
        assert listed == json.loads(capsule.read_file(man["Id"], "MANIFEST.json",
                                                      root=str(tmp_path)))

    def test_read_file_blocks_path_traversal(self, side, tmp_path):
        capsule = mod(side, "telemetry.capsule")
        man = capsule.capture("guard", root=str(tmp_path))
        root = str(tmp_path)
        assert capsule.read_file("../evil", "x", root=root) is None
        assert capsule.read_file("no/slash", "x", root=root) is None
        assert capsule.read_file(man["Id"], "../MANIFEST.json", root=root) is None
        assert capsule.read_file(man["Id"], ".hidden", root=root) is None
        assert capsule.read_file(man["Id"], "MANIFEST.json", root=root)

    def test_retention_keeps_newest_and_prunes_stale_partials(self, side, tmp_path):
        capsule = mod(side, "telemetry.capsule")
        root = str(tmp_path)
        partial = tmp_path / "1000000000000-0-crashed"
        partial.mkdir()
        os.utime(partial, (time.time() - 7200, time.time() - 7200))
        ids = [capsule.capture(f"cap{i}", root=root)["Id"] for i in range(capsule._KEEP + 3)]
        kept = [c["Id"] for c in capsule.list_capsules(root=root)]
        assert len(kept) == capsule._KEEP
        assert kept == ids[-capsule._KEEP:]
        assert not partial.exists()

    def test_autocapture_cooldown(self, side):
        capsule = mod(side, "telemetry.capsule")
        key = f"unit-cooldown-key-{side}"
        assert capsule.should_autocapture(key, now=5000.0)
        assert not capsule.should_autocapture(key, now=5001.0)
        assert capsule.should_autocapture(key, now=5001.0 + capsule._COOLDOWN_S)

    def test_coordinator_respects_kill_switch(self, side):
        capsule = mod(side, "telemetry.capsule")
        calls = []
        coord = capsule.CaptureCoordinator(node="n1", peers_fn=lambda row: calls.append(row),
                                           enabled_fn=lambda: False)
        coord({"Alert": "a", "Target": "t"})
        assert calls == []


def test_capsule_manifests_equal_the_references(tmp_path):
    """One capture on each package, with a provider that raises beside
    the defaults: the manifests' keys and file lists (names, and which
    failed, with the provider's error) are equal; the port's capture
    thread from an alert is joined by its coordinator."""
    got = {}
    for side in SIDES:
        capsule = mod(side, "telemetry.capsule")

        def broken():
            raise RuntimeError("provider exploded")

        capsule.add_provider("broken", broken)
        try:
            man = capsule.capture("equal manifests", trigger="alert", node="n1:80",
                                  root=str(tmp_path / side))
        finally:
            with capsule._lock:
                capsule._providers.pop("broken", None)
        got[side] = (sorted(man), man["Trigger"], man["Reason"],
                     [(f["Name"], f["Ok"], f.get("Error")) for f in man["Files"]],
                     sorted(os.listdir(tmp_path / side / man["Id"])))
    assert got["port"] == got["ref"]
    assert ("broken.json", False, "provider exploded") in got["port"][3]

    capsule = mod("port", "telemetry.capsule")
    capsule.set_dir(str(tmp_path / "coordinated"))
    try:
        coord = capsule.CaptureCoordinator(node="n1:80", enabled_fn=lambda: True)
        coord({"Alert": "unit-join", "Target": f"t-{time.time()}"})
        coord.join()
        assert [c["Trigger"] for c in capsule.list_capsules()] == ["alert"]
    finally:
        capsule.set_dir("")


# ----------------------------------------------------------------------
# collector: sticky scrape targets with a dead-node TTL


class _StubTopology:
    @staticmethod
    def data_nodes():
        return []


class _StubMaster:
    host, port = "127.0.0.1", 1
    is_leader = True
    repair = None
    topology = _StubTopology()

    @staticmethod
    def gateway_registrations():
        return {}


@pytest.mark.parametrize("side", SIDES)
class TestDeadNodeTTL:
    def _collector(self, side):
        return mod(side, "telemetry.collector").ClusterCollector(
            _StubMaster(), interval=1.0, forget_after=0.0)

    def test_forget_after_floored_above_staleness_grace(self, side):
        c = self._collector(side)
        assert c.forget_after >= c.stale_after + 2.0 * c.interval

    def test_stale_target_alerts_first_then_is_forgotten(self, side):
        metrics = mod(side, "stats.metrics")
        c = self._collector(side)
        url = "10.9.9.9:8080"
        now = time.time()
        ts = mod(side, "telemetry.ring").TargetStore(url, "volume")
        ts.last_success = now - (c.stale_after + 0.5)
        c.targets[url] = ts
        metrics.SCRAPE_UP.set(0.0, url)
        metrics.SCRAPE_STALENESS.set(99.0, url)
        c._discover()
        assert url in c.targets
        c._evaluate(list(c.targets.values()), now)
        assert any(a["Alert"] == "scrape_staleness" and a["Target"] == url
                   for a in c.alerts.firing())
        ts.last_success = now - (c.forget_after + 0.5)
        c._discover()
        assert url not in c.targets
        assert (url,) not in metrics.SCRAPE_UP._values
        assert (url,) not in metrics.SCRAPE_STALENESS._values
        c._evaluate(list(c.targets.values()), now)
        assert not any(a["Target"] == url for a in c.alerts.firing())

    def test_discovered_target_never_forgotten(self, side):
        c = self._collector(side)
        url = f"{_StubMaster.host}:{_StubMaster.port}"
        c._discover()
        c.targets[url].first_seen = time.time() - 10_000.0
        c._discover()
        assert url in c.targets


def test_collector_floors_equal_the_references():
    got = {}
    for side in SIDES:
        rows = []
        for interval in (0.3, 1.0, 10.0):
            for forget in (0.0, 5.0, 3600.0):
                c = mod(side, "telemetry.collector").ClusterCollector(
                    _StubMaster(), interval=interval, forget_after=forget)
                rows.append((c.window_s, c.stale_after, c.forget_after))
        got[side] = rows
    assert got["port"] == got["ref"]
