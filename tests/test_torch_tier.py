"""The port's lifecycle tiering (tier/) against seaweedfs_tpu's, on the CPU.

tests/test_tier_ec.py, tests/test_tier_cluster.py and the .dat half of
tests/test_tier.py ported, each case on both packages. The reference
runs its cpu codec, the port the cuda backend on device="cpu" (the
kernels' plain versions). One sealed EC volume is written and encoded
by the reference and copied for each package, so both engines start
from the same bytes: the rules' decisions, tier-out and tier-in of an
EC volume against a `dir` backend (each package its own registry and
directory), the .ecc CRC gate on recall, restart discovery and the
chaos backend must give equal results and byte-identical shards and
reads. The cluster cases run on each package's own master and three
volume servers: /tier/move and /tier/status, the WEED_TIER=0 kill
switch, typed bad requests, the shell's tier.status and tier.move, and
the master's TierScheduler scans. `NewestShardMtime` holds wall-clock
time and is left out of the status comparison. The S3 remote tier and
the S3 gateway's range reads wait for the filer and its gateways
(ROADMAP item 11): the port's .dat tier runs against a `dir` backend.
The tolerance is equality.
"""

from __future__ import annotations

import io
import json
import os
import random
import shutil
import time
import types
import urllib.error
import urllib.request

import pytest

import seaweedfs_tpu.ec.codec as ref_codec
import seaweedfs_tpu.ec.ec_files as ref_ec_files
import seaweedfs_tpu.ec.ec_volume as ref_ec_volume
import seaweedfs_tpu.ec.ecc_sidecar as ref_ecc
import seaweedfs_tpu.stats.metrics as ref_metrics
import seaweedfs_tpu.storage.backend as ref_backend
import seaweedfs_tpu.storage.backend_chaos as ref_chaos
import seaweedfs_tpu.storage.needle as ref_needle
import seaweedfs_tpu.storage.store as ref_store
import seaweedfs_tpu.storage.volume as ref_volume
import seaweedfs_tpu.tier as ref_tier
import seaweedfs_tpu.tier.ec_tier as ref_ec_tier
import seaweedfs_tpu_torch.ec.ec_files as port_ec_files
import seaweedfs_tpu_torch.ec.ec_volume as port_ec_volume
import seaweedfs_tpu_torch.stats.metrics as port_metrics
import seaweedfs_tpu_torch.storage.backend as port_backend
import seaweedfs_tpu_torch.storage.backend_chaos as port_chaos
import seaweedfs_tpu_torch.storage.store as port_store
import seaweedfs_tpu_torch.tier as port_tier
import seaweedfs_tpu_torch.tier.ec_tier as port_ec_tier
from seaweedfs_tpu_torch.util.crc import crc32c

SIDES = ("ref", "port")
VID = 7
PKG = {
    "ref": types.SimpleNamespace(
        tier=ref_tier, ec_tier=ref_ec_tier, store=ref_store, bk=ref_backend,
        chaos=ref_chaos, metrics=ref_metrics, ec_volume=ref_ec_volume,
        ec_files=ref_ec_files, store_kw=dict(ec_backend="cpu"),
        codec=dict(ec_codec="cpu")),
    "port": types.SimpleNamespace(
        tier=port_tier, ec_tier=port_ec_tier, store=port_store, bk=port_backend,
        chaos=port_chaos, metrics=port_metrics, ec_volume=port_ec_volume,
        ec_files=port_ec_files, store_kw=dict(ec_backend="cuda", device="cpu"),
        codec=dict(ec_codec="cuda", device="cpu")),
}
WALL_CLOCK_FIELDS = ("NewestShardMtime",)


def _file_crc(path):
    with open(path, "rb") as f:
        return crc32c(f.read())


def _shards(base):
    out = {}
    for sid in range(14):
        path = base + ref_ec_files.to_ext(sid)
        if os.path.exists(path):
            with open(path, "rb") as f:
                out[sid] = f.read()
    return out


@pytest.fixture(scope="module")
def sealed(tmp_path_factory):
    """A sealed EC volume with its .ecc sidecar, written and encoded
    once by the reference: the directory and the needles' payloads."""
    d = str(tmp_path_factory.mktemp("sealed"))
    v = ref_volume.Volume(d, VID)
    rng = random.Random(11)
    payload = {}
    for k in range(1, 31):
        data = bytes(rng.randbytes(rng.randint(500, 4000)))
        payload[k] = data
        v.write_needle(ref_needle.Needle(cookie=0x12345678, id=k, data=data))
    v.close()
    base = os.path.join(d, str(VID))
    ref_ec_files.write_ec_files(base, rs=ref_codec.new_encoder(backend="cpu"))
    ref_ec_files.write_sorted_file_from_idx(base)
    os.remove(base + ".dat")
    os.remove(base + ".idx")
    ref_ecc.write_sidecar(base, {sid: _file_crc(base + ref_ec_files.to_ext(sid))
                                 for sid in range(14)})
    return d, payload


def _stores(tmp_path, sealed, instance_id):
    """Per side: a copy of the sealed volume mounted by that package's
    Store, and a `dir` backend registered under `instance_id`."""
    src, payload = sealed
    out = {}
    for side in SIDES:
        pkg = PKG[side]
        d = str(tmp_path / side / "vols")
        shutil.copytree(src, d)
        bdir = str(tmp_path / side / f"backend_{instance_id}")
        os.makedirs(bdir)
        pkg.bk.ensure_builtin_factories()
        pkg.bk.load_backend_config({"dir": {instance_id: {"enabled": True, "dir": bdir}}})
        store = pkg.store.Store([d], **pkg.store_kw)
        assert store.find_ec_volume(VID) is not None
        out[side] = types.SimpleNamespace(store=store, base=os.path.join(d, str(VID)),
                                          bdir=bdir, name=f"dir.{instance_id}")
    return out, payload


def _status(pkg, store):
    st = pkg.ec_tier.tier_status(store)
    for row in st.values():
        for name in WALL_CLOCK_FIELDS:
            row.pop(name)
    return st


# ---------------------------------------------------------------------------
@pytest.mark.parametrize("side", SIDES)
class TestTierRules:
    def test_hysteresis(self, side):
        r = PKG[side].tier.TierRules(min_age_s=100.0, cold_reads_per_s=0.1,
                                     hot_reads_per_s=1.0)
        assert r.decide(age_s=50.0, reads_per_s=0.0, tiered=False) is None
        assert r.decide(age_s=500.0, reads_per_s=0.5, tiered=False) is None
        assert r.decide(age_s=500.0, reads_per_s=0.05, tiered=False) == "out"
        assert r.decide(age_s=500.0, reads_per_s=0.5, tiered=True) is None
        assert r.decide(age_s=500.0, reads_per_s=2.0, tiered=True) == "in"

    def test_from_env(self, side, monkeypatch):
        monkeypatch.setenv("WEED_TIER_BACKEND", "dir.cold")
        monkeypatch.setenv("WEED_TIER_MIN_AGE_S", "42")
        monkeypatch.setenv("WEED_TIER_COLD_RPS", "0.5")
        monkeypatch.setenv("WEED_TIER_HOT_RPS", "3")
        r = PKG[side].tier.TierRules.from_env()
        assert (r.backend, r.min_age_s, r.cold_reads_per_s, r.hot_reads_per_s) == \
            ("dir.cold", 42.0, 0.5, 3.0)
        assert r.to_dict() == ref_tier.TierRules.from_env().to_dict()

    def test_kill_switch(self, side, monkeypatch):
        monkeypatch.setenv("WEED_TIER", "0")
        assert not PKG[side].tier.tier_enabled()
        monkeypatch.delenv("WEED_TIER")
        assert PKG[side].tier.tier_enabled()


def test_rules_decide_alike_on_seeded_signals():
    rng = random.Random(5)
    for _ in range(300):
        kw = dict(min_age_s=rng.choice([0.0, 60.0, 3600.0]),
                  cold_reads_per_s=rng.choice([0.0, 0.05, 1.0]),
                  hot_reads_per_s=rng.choice([0.5, 1.0, 10.0]))
        sig = dict(age_s=rng.uniform(0, 7200), reads_per_s=rng.choice([0.0, 0.05, 0.7, 20.0]),
                   tiered=rng.random() < 0.5)
        assert port_tier.TierRules(**kw).decide(**sig) == ref_tier.TierRules(**kw).decide(**sig)


# ---------------------------------------------------------------------------
class TestEcTierRoundTrip:
    def test_out_then_in_byte_identical(self, tmp_path, sealed):
        sides, payload = _stores(tmp_path, sealed, "rt1")
        before = _shards(sides["ref"].base)
        results = {}
        for side, s in sides.items():
            pkg = PKG[side]
            out = pkg.ec_tier.tier_out_ec(s.store, VID, s.name)
            ev = s.store.find_ec_volume(VID)
            assert ev.remote is not None and ev.shards == {}
            assert _shards(s.base) == {}
            assert os.path.exists(s.base + ".evf") and os.path.exists(s.base + ".ecx")
            assert pkg.ec_tier.tiered_volume_count(s.store) == 1
            assert ev.serving_shard_ids() == list(range(14))
            status_out = _status(pkg, s.store)
            r0 = pkg.metrics.TIER_REMOTE_READS.value()
            for k, data in payload.items():
                assert bytes(ev.read_needle(k).data) == data
            assert pkg.metrics.TIER_REMOTE_READS.value() > r0
            back = pkg.ec_tier.tier_in_ec(s.store, VID)
            assert ev.remote is None and not os.path.exists(s.base + ".evf")
            assert _shards(s.base) == before
            assert [f for f in os.listdir(s.bdir) if not f.endswith(".part")] == []
            for k, data in payload.items():
                assert bytes(ev.read_needle(k).data) == data
            results[side] = (out, status_out, back, _status(pkg, s.store))
            s.store.close()
        assert results["ref"] == results["port"]
        assert results["port"][0]["Shards"] == list(range(14))

    def test_short_circuits_and_unknown_backend(self, tmp_path, sealed):
        sides, _ = _stores(tmp_path, sealed, "sc1")
        got = {}
        for side, s in sides.items():
            et = PKG[side].ec_tier
            with pytest.raises(ValueError, match="not configured"):
                et.tier_out_ec(s.store, VID, "dir.no-such-instance")
            with pytest.raises(ValueError, match="not found"):
                et.tier_out_ec(s.store, 999, s.name)
            got[side] = [et.tier_in_ec(s.store, VID), et.tier_out_ec(s.store, VID, s.name),
                         et.tier_out_ec(s.store, VID, s.name)]
            s.store.close()
        assert got["ref"] == got["port"]
        assert got["port"][2] == {"VolumeId": VID, "AlreadyTiered": True}

    def test_restart_discovers_tiered_volume(self, tmp_path, sealed):
        sides, payload = _stores(tmp_path, sealed, "rs1")
        for side, s in sides.items():
            pkg = PKG[side]
            pkg.ec_tier.tier_out_ec(s.store, VID, s.name)
            store2 = pkg.store.Store([os.path.dirname(s.base)], **pkg.store_kw)
            ev2 = store2.find_ec_volume(VID)
            assert ev2 is not None and ev2.remote is not None
            assert ev2.remote.backend_name == s.name
            for k, data in payload.items():
                assert bytes(ev2.read_needle(k).data) == data
            pkg.ec_tier.tier_in_ec(store2, VID)
            assert store2.find_ec_volume(VID).remote is None
            store2.close()
            s.store.close()
        assert _shards(sides["ref"].base) == _shards(sides["port"].base)

    @pytest.mark.parametrize("sid", [3, 12])
    def test_tier_in_rejects_corrupt_backend_copy(self, tmp_path, sealed, sid):
        sides, _ = _stores(tmp_path, sealed, f"crc{sid}")
        errors = {}
        for side, s in sides.items():
            et = PKG[side].ec_tier
            et.tier_out_ec(s.store, VID, s.name)
            ev = s.store.find_ec_volume(VID)
            path = os.path.join(s.bdir, ev.remote.shards[sid]["key"])
            with open(path, "r+b") as f:
                f.seek(100)
                b = f.read(1)
                f.seek(100)
                f.write(bytes([b[0] ^ 0xFF]))
            with pytest.raises(IOError, match="CRC mismatch") as e:
                et.tier_in_ec(s.store, VID)
            errors[side] = str(e.value)
            assert ev.remote is not None and os.path.exists(s.base + ".evf")
            assert not any(f.endswith(".tierin") for f in os.listdir(os.path.dirname(s.base)))
            # the shards recalled before the corrupt one stay local
            assert sorted(ev.shards) == list(range(sid))
            s.store.close()
        assert errors["ref"] == errors["port"]


class TestChaosBackend:
    def test_erroring_backend_degrades_then_heals(self, tmp_path, sealed):
        sides, payload = _stores(tmp_path, sealed, "chaos1")
        k = next(iter(payload))
        for side, s in sides.items():
            pkg = PKG[side]
            pkg.ec_tier.tier_out_ec(s.store, VID, s.name)
            ev = s.store.find_ec_volume(VID)
            inner = pkg.bk.get_backend(s.name)
            chaos = pkg.chaos.ChaosBackendStorage(
                inner, faults=[pkg.chaos.BackendFault("eio", ops=("read",))])
            pkg.bk.register_backend(chaos)
            try:
                e0 = pkg.metrics.TIER_REMOTE_READ_ERRORS.value()
                with pytest.raises(pkg.ec_volume.NotEnoughShards):
                    ev.read_needle(k)
                assert pkg.metrics.TIER_REMOTE_READ_ERRORS.value() > e0
                assert chaos.raised > 0
                assert s.store.find_ec_volume(VID) is ev and ev.remote is not None
                chaos.heal()
                assert bytes(ev.read_needle(k).data) == payload[k]
            finally:
                pkg.bk.register_backend(inner)
                s.store.close()

    def test_slow_backend_still_serves(self, tmp_path, sealed):
        sides, payload = _stores(tmp_path, sealed, "chaos2")
        for side, s in sides.items():
            pkg = PKG[side]
            pkg.ec_tier.tier_out_ec(s.store, VID, s.name)
            ev = s.store.find_ec_volume(VID)
            inner = pkg.bk.get_backend(s.name)
            pkg.bk.register_backend(pkg.chaos.ChaosBackendStorage(
                inner, faults=[pkg.chaos.BackendFault("slow", ops=("read",), delay_s=0.02)]))
            try:
                for key in list(payload)[:5]:
                    assert bytes(ev.read_needle(key).data) == payload[key]
            finally:
                pkg.bk.register_backend(inner)
                s.store.close()


# ---------------------------------------------------------------------------
# live clusters: a master and three volume servers per package, no filer
BACKEND = "dir.clu"


def wait_for(predicate, timeout=30.0, step=0.1):
    deadline = time.time() + timeout
    while time.time() < deadline:
        if predicate():
            return True
        time.sleep(step)
    return False


@pytest.fixture(scope="module", params=SIDES)
def tier_cluster(request, tmp_path_factory):
    from seaweedfs_tpu.server.master_server import MasterServer as RefMaster
    from seaweedfs_tpu.server.volume_server import VolumeServer as RefVolume
    from seaweedfs_tpu_torch.server.master_server import MasterServer as PortMaster
    from seaweedfs_tpu_torch.server.volume_server import VolumeServer as PortVolume
    from seaweedfs_tpu_torch.util.availability import free_port

    side = request.param
    Master, Volume = (RefMaster, RefVolume) if side == "ref" else (PortMaster, PortVolume)
    backend_dir = str(tmp_path_factory.mktemp(f"{side}-tierbk"))
    storage_cfg = {"dir": {"clu": {"enabled": True, "dir": backend_dir}}}
    master = Master(port=free_port(), volume_size_limit_mb=64, vacuum_interval=0)
    master.start()
    servers = []
    for i in range(3):
        vs = Volume([str(tmp_path_factory.mktemp(f"{side}-tiervol{i}"))], port=free_port(),
                    master=f"127.0.0.1:{master.port}", rack=f"rack{i % 2}",
                    heartbeat_interval=0.2, max_volume_counts=[100], scrub_interval=0,
                    storage_backends=storage_cfg, **PKG[side].codec)
        vs.start()
        servers.append(vs)
    assert wait_for(lambda: len(master.topology.data_nodes()) == 3, 45)
    yield side, master, servers, backend_dir
    for vs in servers:
        vs.stop()
    master.stop()


def _shell(side):
    if side == "ref":
        from seaweedfs_tpu.shell import command_env, commands
    else:
        from seaweedfs_tpu_torch.shell import command_env, commands
    return command_env, commands


def _post_json(url, timeout=120.0):
    req = urllib.request.Request(url, method="POST", data=b"")
    with urllib.request.urlopen(req, timeout=timeout) as r:
        return json.loads(r.read())


def _get_json(url, timeout=10.0):
    with urllib.request.urlopen(url, timeout=timeout) as r:
        return json.loads(r.read())


def _holders(servers, vid):
    return [s for s in servers if s.store.find_ec_volume(vid) is not None]


def _registered_shards(master, vid):
    locs = master.topology.lookup_ec_shards(vid)
    return 0 if locs is None else sum(1 for nodes in locs.locations if nodes)


def _encode(side, master, collection, n=8):
    from seaweedfs_tpu_torch.util.availability import write_keyset

    command_env, commands = _shell(side)
    vid, keys, _src = write_keyset(
        master.port, collection, n=n,
        payload_fn=lambda i: (f"{collection} {i} ".encode() * 2500)[: 15000 + i])
    env = command_env.CommandEnv([f"127.0.0.1:{master.port}"])
    commands.do_ec_encode(env, vid, collection, io.StringIO())
    assert wait_for(lambda: _registered_shards(master, vid) == 14, 30)
    return vid, keys, env


def _read_all(master, collection, keys):
    for fid, want in keys.items():
        with urllib.request.urlopen(
                f"http://127.0.0.1:{master.port}/{fid}?collection={collection}",
                timeout=15) as r:
            assert r.read() == want, f"fid {fid} corrupt"


class TestManualTierMoves:
    def test_out_degraded_reads_then_in(self, tier_cluster):
        side, master, servers, backend_dir = tier_cluster
        _, commands = _shell(side)
        vid, keys, env = _encode(side, master, "tiered")
        shards = {vs.port: _shards(vs.store.find_ec_volume(vid).base_name)
                  for vs in _holders(servers, vid)}
        moved = 0
        for vs in _holders(servers, vid):
            res = _post_json(f"http://{vs.host}:{vs.port}/tier/move"
                             f"?volumeId={vid}&direction=out&destination={BACKEND}")
            assert res.get("Backend") == BACKEND, res
            moved += len(res.get("Shards") or [])
        assert moved == 14
        for vs in _holders(servers, vid):
            ev = vs.store.find_ec_volume(vid)
            assert ev.shards == {} and ev.remote is not None
            assert _get_json(f"http://{vs.host}:{vs.port}/tier/status")[str(vid)]["Tiered"]
        assert len(os.listdir(backend_dir)) >= 14
        assert wait_for(lambda: _registered_shards(master, vid) == 14, 15)
        _read_all(master, "tiered", keys)
        out = commands.run_command(env, "tier.status")
        assert "TIERED" in out and BACKEND in out
        out = commands.run_command(env, f"tier.move -volumeId {vid} -in")
        assert "FAILED" not in out
        for vs in _holders(servers, vid):
            ev = vs.store.find_ec_volume(vid)
            assert ev.remote is None and ev.shards
            assert _shards(ev.base_name) == shards[vs.port]
        _read_all(master, "tiered", keys)

    def test_kill_switch_forbids_moves(self, tier_cluster, monkeypatch):
        side, master, servers, _bd = tier_cluster
        vid, keys, _env = _encode(side, master, "killsw")
        monkeypatch.setenv("WEED_TIER", "0")
        vs = _holders(servers, vid)[0]
        with pytest.raises(urllib.error.HTTPError) as e:
            _post_json(f"http://{vs.host}:{vs.port}/tier/move"
                       f"?volumeId={vid}&direction=out&destination={BACKEND}")
        assert e.value.code == 403
        sched = PKG[side].tier.TierScheduler(
            master, interval=3600,
            rules=PKG[side].tier.TierRules(backend=BACKEND, min_age_s=0.0,
                                           cold_reads_per_s=1e9))
        assert sched.scan_once() == 0
        monkeypatch.delenv("WEED_TIER")
        for vs in _holders(servers, vid):
            assert vs.store.find_ec_volume(vid).remote is None
        _read_all(master, "killsw", keys)

    def test_bad_requests_are_typed(self, tier_cluster):
        _side, _master, servers, _bd = tier_cluster
        vs = servers[0]
        base = f"http://{vs.host}:{vs.port}/tier/move"
        for qs, code in (("volumeId=abc&direction=out&destination=d", 400),
                         ("volumeId=123456&direction=sideways", 400),
                         ("volumeId=123456&direction=out", 400),
                         ("volumeId=123456&direction=in", 404)):
            with pytest.raises(urllib.error.HTTPError) as e:
                _post_json(f"{base}?{qs}")
            assert e.value.code == code, qs

    def test_dat_tier_upload_read_download(self, tier_cluster):
        """The .dat tier verbs (volume.tier.upload / download) against a
        `dir` backend: reads ride ranged reads of the backend copy."""
        from seaweedfs_tpu_torch.client import operation as op

        side, master, servers, _bd = tier_cluster
        command_env, commands = _shell(side)
        env = command_env.CommandEnv([f"127.0.0.1:{master.port}"])
        maddr = f"127.0.0.1:{master.port}"
        fids = []
        for i in range(5):
            ar = op.assign(maddr, collection="datier")
            payload = f"tiered needle {i}".encode() * 50
            assert not op.upload(f"{ar.url}/{ar.fid}", payload, jwt=ar.auth).error
            fids.append((ar.fid, payload, ar.url))
        vid = int(fids[0][0].split(",")[0])
        url = fids[0][2]
        vs = next(s for s in servers if f"{s.host}:{s.port}" == url)
        out = commands.run_command(env, f"volume.tier.upload -volumeId {vid} -dest {BACKEND}")
        assert f"volume {vid} dat moved to {BACKEND}" in out
        vol = vs.store.find_volume(vid)
        assert vol.has_remote_file() and vol.read_only
        assert not os.path.exists(vol.base_name + ".dat")
        for fid, payload, _ in fids:
            if int(fid.split(",")[0]) == vid:
                assert op.download(f"{url}/{fid}")[0] == payload
        out = commands.run_command(env, f"volume.tier.download -volumeId {vid}")
        assert f"volume {vid} dat restored locally" in out
        assert not vol.has_remote_file() and os.path.exists(vol.base_name + ".dat")
        for fid, payload, _ in fids:
            if int(fid.split(",")[0]) == vid:
                assert op.download(f"{url}/{fid}")[0] == payload


class TestTierScheduler:
    def test_scan_tiers_cold_volume_and_reports(self, tier_cluster):
        side, master, servers, _bd = tier_cluster
        vid, keys, _env = _encode(side, master, "coldsched")
        tier = PKG[side].tier
        sched = tier.TierScheduler(
            master, interval=3600,
            rules=tier.TierRules(backend=BACKEND, min_age_s=0.0, cold_reads_per_s=1e9,
                                 hot_reads_per_s=1e12),
            concurrency=32, cooldown_s=0.0)
        master.tier = sched
        try:
            assert sched.scan_once() >= 1
            assert wait_for(lambda: all(
                vs.store.find_ec_volume(vid).remote is not None
                and not vs.store.find_ec_volume(vid).shards
                for vs in _holders(servers, vid)), 60), sched.status_snapshot()
            assert wait_for(lambda: sched.status_snapshot()["Active"] == 0, 30)
            snap = _get_json(f"http://127.0.0.1:{master.port}/cluster/tier")
            assert snap["MovesStarted"] >= 1 and snap["Rules"]["Backend"] == BACKEND
            assert any(h["Direction"] == "out" for h in snap["History"])
            assert not any(h["Error"] for h in snap["History"]), snap
            assert set(snap) == set(ref_tier.TierScheduler(master).status_snapshot())
            _read_all(master, "coldsched", keys)
            time.sleep(0.1)
            assert wait_for(lambda: sched.scan_once() == 0
                            and sched.status_snapshot()["Active"] == 0, 60)
        finally:
            master.tier = None
            sched.stop()

    def test_cluster_tier_endpoint_disabled_by_default(self, tier_cluster):
        _side, master, _servers, _bd = tier_cluster
        snap = _get_json(f"http://127.0.0.1:{master.port}/cluster/tier")
        assert snap.get("Disabled") is True


@pytest.mark.parametrize("side", SIDES)
def test_master_tier_interval_runs_the_scheduler(side, tmp_path):
    """tier_interval > 0 builds and starts the scheduler; stop() ends
    its thread."""
    from seaweedfs_tpu.server.master_server import MasterServer as RefMaster
    from seaweedfs_tpu_torch.server.master_server import MasterServer as PortMaster
    from seaweedfs_tpu_torch.util.availability import free_port

    Master = RefMaster if side == "ref" else PortMaster
    master = Master(port=free_port(), vacuum_interval=0, tier_interval=0.2,
                    tier_kwargs={"rules": PKG[side].tier.TierRules(backend="")})
    master.start()
    try:
        assert wait_for(lambda: master.tier.last_scan_unix > 0, 10)
        snap = _get_json(f"http://127.0.0.1:{master.port}/cluster/tier")
        assert snap["IntervalSeconds"] == 0.2 and snap["Enabled"] is True
    finally:
        master.stop()
    assert not master.tier._thread.is_alive()
