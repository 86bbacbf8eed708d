"""The port's node-health plane against seaweedfs_tpu's, on the CPU.

tests/test_health.py's unit cases of the phi-accrual detector, the node
state machine, the HealthPlane, the disk watchdog and the health-aware
pick run on both packages (the `hm` fixture). Then one seeded sequence
of heartbeats, error counters, flags, drains and deaths goes into a
reference and a port HealthPlane on a pinned clock: every verdict and
the /cluster/health payload (JSON identity) must be equal at each step.
The multi-process e2e cases of test_health.py are not ported here.
"""

import errno
import json
import random
import time
import types

import pytest

import seaweedfs_tpu.cluster.health as ref_health
import seaweedfs_tpu.storage.store as ref_store
import seaweedfs_tpu.topology.node as ref_node
import seaweedfs_tpu.topology.volume_layout as ref_layout
import seaweedfs_tpu.util.deadline as ref_deadline
import seaweedfs_tpu_torch.cluster.health as port_health
import seaweedfs_tpu_torch.storage.store as port_store
import seaweedfs_tpu_torch.topology.node as port_node
import seaweedfs_tpu_torch.topology.volume_layout as port_layout
import seaweedfs_tpu_torch.util.deadline as port_deadline

MODS = {
    "ref": types.SimpleNamespace(h=ref_health, VolumeInfo=ref_store.VolumeInfo,
                                 DataNode=ref_node.DataNode,
                                 VolumeLayout=ref_layout.VolumeLayout,
                                 DeadlineExceeded=ref_deadline.DeadlineExceeded),
    "port": types.SimpleNamespace(h=port_health, VolumeInfo=port_store.VolumeInfo,
                                  DataNode=port_node.DataNode,
                                  VolumeLayout=port_layout.VolumeLayout,
                                  DeadlineExceeded=port_deadline.DeadlineExceeded),
}


@pytest.fixture(params=["ref", "port"])
def hm(request):
    return MODS[request.param]


# --- phi-accrual detector ----------------------------------------------------


def _warm(h, interval=0.2, n=20, start=100.0):
    p = h.PhiAccrual()
    t = start
    for _ in range(n):
        p.observe(t)
        t += interval
    return p, t


class TestPhiAccrual:
    def test_no_history_is_zero(self, hm):
        p = hm.h.PhiAccrual()
        assert p.phi(100.0) == 0.0
        p.observe(100.0)
        assert p.phi(105.0) == 0.0

    def test_on_cadence_is_low(self, hm):
        p, t = _warm(hm.h)
        assert p.phi(t + 0.05) < 2.0

    def test_silence_grows_suspicion(self, hm):
        p, t = _warm(hm.h, interval=0.2)
        assert p.phi(t + 3 * 0.2) > hm.h.phi_threshold()
        assert p.phi(t + 10 * 0.2) > p.phi(t + 3 * 0.2) > 0

    def test_warmed_and_gate_track_learned_cadence(self, hm):
        p = hm.h.PhiAccrual()
        assert not p.warmed() and p.gate_s() == 0.0
        p, t = _warm(hm.h, interval=0.2, n=20)
        assert p.warmed()
        assert p.gate_s() == pytest.approx(2.0 * 0.2, rel=1e-6)
        p.observe(t - 0.2 + 0.35)
        assert p.gate_s() == pytest.approx(2.0 * 0.35, rel=1e-6)

    def test_outage_resume_interval_not_recorded(self, hm):
        p, t = _warm(hm.h, interval=0.2)
        gate_before = max(p._intervals)
        p.observe(t + 30.0)
        assert max(p._intervals) == gate_before
        assert p.phi(t + 30.0 + 1.0) > hm.h.phi_threshold()

    def test_persistent_cadence_change_relearned(self, hm):
        p, t = _warm(hm.h, interval=0.2)
        tt = t
        for _ in range(30):
            tt += 2.0
            p.observe(tt)
        assert p.phi(tt + 1.0) < hm.h.phi_threshold()

    def test_jittery_cadence_needs_more_silence(self, hm):
        steady, t1 = _warm(hm.h, interval=0.2)
        jittery = hm.h.PhiAccrual()
        t = 100.0
        rng = random.Random(7)
        for _ in range(20):
            jittery.observe(t)
            t += 0.1 + rng.random() * 0.2
        assert jittery.phi(t + 0.6) < steady.phi(t1 + 0.6)


# --- node state machine ------------------------------------------------------


def _beaten(h, interval=0.2, n=20, now=1000.0):
    rec = h.NodeHealth("n1")
    t = now - n * interval
    for _ in range(n):
        rec.observe(t)
        t += interval
    return rec, t


class TestNodeState:
    def test_healthy_on_cadence(self, hm):
        rec, t = _beaten(hm.h)
        assert rec.state(t + 0.05) == hm.h.HEALTHY
        assert rec.assignable(t + 0.05) and not rec.read_demoted(t + 0.05)

    def test_silence_goes_suspect_and_holds(self, hm):
        rec, t = _beaten(hm.h)
        assert rec.state(t + 1.0) == hm.h.SUSPECT
        assert not rec.assignable(t + 1.0) and rec.read_demoted(t + 1.0)
        rec.observe(t + 1.0)
        assert rec.state(t + 1.05) == hm.h.SUSPECT
        tt = t + 1.0
        for _ in range(40):
            tt += 0.2
            rec.observe(tt)
        assert rec.state(tt + 0.05) == hm.h.HEALTHY

    def test_error_ewma_goes_suspect(self, hm):
        rec, t = _beaten(hm.h)
        rec.observe(t + 0.2, io_errors=50, request_errors=0)
        assert rec.err_ewma > hm.h.err_ewma_threshold()
        assert rec.state(t + 0.25) == hm.h.SUSPECT
        assert "err_ewma" in ";".join(rec.suspicion_reasons(t + 0.25))

    def test_counter_reset_not_an_error_burst(self, hm):
        rec, t = _beaten(hm.h)
        rec.observe(t + 0.2, io_errors=50)
        ewma = rec.err_ewma
        rec.observe(t + 0.4, io_errors=0)
        assert rec.err_ewma < ewma

    def test_lame_duck_and_draining_unassignable_but_not_demoted(self, hm):
        rec, t = _beaten(hm.h)
        rec.observe(t + 0.2, lame_duck=True)
        assert not rec.assignable(t + 0.25) and not rec.read_demoted(t + 0.25)
        rec.observe(t + 0.4, lame_duck=False, draining=True)
        assert not rec.assignable(t + 0.45)

    def test_kill_switch_restores_pre_health(self, hm, monkeypatch):
        rec, t = _beaten(hm.h)
        assert rec.state(t + 5.0) == hm.h.SUSPECT
        rec.lame_duck = True
        monkeypatch.setenv("WEED_HEALTH", "0")
        assert rec.state(t + 5.0) == hm.h.HEALTHY
        assert rec.assignable(t + 5.0) and not rec.read_demoted(t + 5.0)

    def test_dead_beats_everything(self, hm):
        rec, t = _beaten(hm.h)
        rec.dead = True
        assert rec.state(t) == hm.h.DEAD and not rec.assignable(t)


class _DN:
    def __init__(self, url):
        self.url = url


class TestHealthPlane:
    def test_order_nodes_demotes_suspects(self, hm):
        hp = hm.h.HealthPlane()
        now = time.monotonic()
        for url in ("a:1", "b:2"):
            rec = hp._get(url)
            t = now - 8.0
            for _ in range(20):
                rec.observe(t)
                t += 0.2
        hp._get("a:1").observe(now)
        ordered = hp.order_nodes([_DN("b:2"), _DN("a:1")])
        assert [d.url for d in ordered] == ["a:1", "b:2"]
        assert hp.suspect("b:2") and not hp.suspect("a:1")

    def test_unknown_nodes_are_healthy(self, hm):
        hp = hm.h.HealthPlane()
        assert hp.state("never:seen") == hm.h.HEALTHY and hp.assignable("never:seen")

    def test_drain_registry(self, hm):
        hp = hm.h.HealthPlane()
        hp.request_drain("x:1")
        assert hp.draining_urls() == {"x:1"}
        hp.request_drain("x:1", stop=True)
        assert hp.draining_urls() == set()


class TestDiskWatchdog:
    def test_disk_class_strikes_trip_lame_duck(self, hm):
        wd = hm.h.DiskWatchdog(strikes=3, window_s=60)
        tripped = []
        wd.on_trip = lambda: tripped.append(1)
        assert wd.note_io_error(OSError(errno.EIO, "eio"))
        assert not wd.lame_duck
        assert wd.note_io_error(OSError(errno.ENOSPC, "enospc"))
        assert wd.note_io_error(OSError(errno.EIO, "eio"))
        assert wd.lame_duck and tripped == [1] and wd.io_errors == 3

    def test_non_disk_errors_ignored(self, hm):
        wd = hm.h.DiskWatchdog(strikes=1)
        assert not wd.note_io_error(ConnectionResetError("peer"))
        assert not wd.note_io_error(hm.DeadlineExceeded("budget"))
        assert not wd.note_io_error(OSError(errno.ENOENT, "missing"))
        assert not wd.lame_duck and wd.io_errors == 0


class TestHealthPick:
    def _layout(self, hm):
        lay = hm.VolumeLayout("000", "", 1 << 30)
        for vid, url in ((1, "a:1"), (2, "b:2"), (3, "c:3")):
            dn = hm.DataNode(url)
            dn.ip, dn.port = url.split(":")[0], int(url.split(":")[1])
            lay.register_volume(hm.VolumeInfo(
                id=vid, size=0, collection="", file_count=0, delete_count=0,
                deleted_byte_count=0, read_only=False, replica_placement=0,
                version=3, ttl=0), dn)
        return lay

    class _FakeHealth:
        def __init__(self, bad):
            self.bad = set(bad)

        def assignable(self, url):
            return url not in self.bad

    def test_suspect_replica_volumes_excluded(self, hm):
        lay = self._layout(hm)
        fake = self._FakeHealth({"b:2"})
        for policy in ("random", "p2c"):
            assert {lay.pick_for_write(policy=policy, health=fake)[0]
                    for _ in range(50)} == {1, 3}

    def test_all_tainted_falls_back_to_full_pool(self, hm):
        lay = self._layout(hm)
        fake = self._FakeHealth({"a:1", "b:2", "c:3"})
        assert {lay.pick_for_write(policy="random", health=fake)[0]
                for _ in range(60)} == {1, 2, 3}

    def test_health_none_is_pre_health(self, hm):
        lay = self._layout(hm)
        assert {lay.pick_for_write(policy="random", health=None)[0]
                for _ in range(60)} == {1, 2, 3}


# --- one sequence through both planes ----------------------------------------


class _Beat:
    def __init__(self, **kw):
        self.__dict__.update(kw)


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_same_signals_same_verdicts(seed, monkeypatch):
    """Beats with seeded gaps (some long enough to go suspect), error
    counter bursts and resets, lame-duck and draining flags, operator
    drains, scrub flags and deaths, on a pinned monotonic clock: both
    planes give the same state, assignability, suspicion and node order
    after every event, and the same /cluster/health payload."""
    clock = [5000.0]
    monkeypatch.setattr(time, "monotonic", lambda: clock[0])
    rng = random.Random(seed)
    planes = {k: MODS[k].h.HealthPlane() for k in MODS}
    urls = [f"10.0.0.{i}:8080" for i in range(5)]
    counters = {u: [0, 0] for u in urls}
    for step in range(400):
        clock[0] += rng.choice((0.2, 0.2, 0.2, 0.21, 0.19, 0.6, 1.5))
        url = rng.choice(urls)
        kind, flip = rng.random(), rng.random() < 0.5
        for hp in planes.values():
            if 0.8 <= kind < 0.85:
                hp.request_drain(url, stop=flip)
            elif 0.85 <= kind < 0.9:
                hp.observe_scrub(url, flip)
            elif 0.9 <= kind < 0.93:
                hp.note_dead(url)
        if kind < 0.8:
            c = counters[url]
            if rng.random() < 0.1:
                c[0] += rng.randrange(1, 40)
            if rng.random() < 0.05:
                c[:] = [0, 0]  # the node restarted
            c[1] += rng.randrange(0, 3)
            beat = _Beat(io_errors=c[0], request_errors=c[1],
                         lame_duck=rng.random() < 0.05, draining=rng.random() < 0.05)
            for hp in planes.values():
                hp.observe_heartbeat(url, beat)
        verdicts = {
            k: ([(hp.state(u), hp.assignable(u), hp.suspect(u)) for u in urls],
                [d.url for d in hp.order_nodes([_DN(u) for u in urls])],
                sorted(hp.draining_urls()))
            for k, hp in planes.items()
        }
        assert verdicts["ref"] == verdicts["port"], (seed, step)
    assert json.dumps(planes["ref"].payload(), sort_keys=True) == json.dumps(
        planes["port"].payload(), sort_keys=True)
