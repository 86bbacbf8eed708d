"""The port's scrub plane against seaweedfs_tpu's, on the CPU.

tests/test_scrub.py ported, each case on both packages. The reference
runs its cpu codec; the port runs the cuda backend on device="cpu"
(K1's and K5's plain versions). The verify core gets the same seeded
shard tiles on both sides and must give the same result: mismatch
counts per parity row, bad tiles, culprits for one and two corrupt
shards, `unlocalized` for three, the resume cursor. The plain scan and
the engine run on one volume written once and copied for each package,
so the files are the same bytes; the engine's scrub_state.json must be
equal but for `last_sweep_unix`, which holds wall-clock time, and its
quarantine must rename the same files. TestSelfHealingEndToEnd and
TestPlainReplicaReplace run the acceptance loop on each package's own
cluster (master RepairScheduler + three volume servers with the scrub
engine on): corruption is found, quarantined and repaired with no
shell command, and every read is byte-identical. The port's ec.verify
is also held equal to the reference's on the same cluster's shards.
The tolerance is equality throughout.
"""

import io
import json
import os
import random
import shutil
import threading
import time
import urllib.request

import numpy as np
import pytest

import seaweedfs_tpu.ec.codec as ref_codec
import seaweedfs_tpu.ec.ec_files as ref_ec_files
import seaweedfs_tpu.scrub.engine as ref_engine
import seaweedfs_tpu.scrub.ratelimit as ref_ratelimit
import seaweedfs_tpu.scrub.verify as ref_verify
import seaweedfs_tpu.storage.needle as ref_needle
import seaweedfs_tpu.storage.store as ref_store
import seaweedfs_tpu.storage.volume as ref_volume
import seaweedfs_tpu_torch.ec.codec as port_codec
import seaweedfs_tpu_torch.ec.ec_files as port_ec_files
import seaweedfs_tpu_torch.scrub.engine as port_engine
import seaweedfs_tpu_torch.scrub.ratelimit as port_ratelimit
import seaweedfs_tpu_torch.scrub.verify as port_verify
import seaweedfs_tpu_torch.storage.store as port_store
import seaweedfs_tpu_torch.storage.volume as port_volume
from tests.faults import corrupt_needle_data, find_ec_shard_path, flip_byte, truncate_by

SIDES = ("ref", "port")
PKG = {
    "ref": dict(verify=ref_verify, ratelimit=ref_ratelimit, engine=ref_engine,
                store=ref_store, volume=ref_volume, ec_files=ref_ec_files,
                rs=lambda: ref_codec.new_encoder(backend="cpu"),
                store_kw=dict(ec_backend="cpu")),
    "port": dict(verify=port_verify, ratelimit=port_ratelimit, engine=port_engine,
                 store=port_store, volume=port_volume, ec_files=port_ec_files,
                 rs=lambda: port_codec.new_encoder(backend="cuda", device="cpu"),
                 store_kw=dict(ec_backend="cuda", device="cpu")),
}
WALL_CLOCK_FIELDS = ("last_sweep_unix",)


def wait_for(predicate, timeout=30.0, step=0.1):
    deadline = time.time() + timeout
    while time.time() < deadline:
        if predicate():
            return True
        time.sleep(step)
    return False


# ---------------------------------------------------------------------------
@pytest.mark.parametrize("side", SIDES)
class TestTokenBucket:
    def test_paces_after_burst(self, side):
        tb = PKG[side]["ratelimit"].TokenBucket(100_000, burst_bytes=50_000)
        t0 = time.perf_counter()
        assert tb.take(50_000)  # burst: instant
        assert tb.take(50_000)  # must wait ~0.5s of refill
        took = time.perf_counter() - t0
        assert 0.3 < took < 3.0, took

    def test_zero_rate_is_unlimited(self, side):
        tb = PKG[side]["ratelimit"].TokenBucket(0)
        t0 = time.perf_counter()
        for _ in range(1000):
            assert tb.take(10**9)
        assert time.perf_counter() - t0 < 0.5

    def test_stop_event_aborts(self, side):
        tb = PKG[side]["ratelimit"].TokenBucket(1.0, burst_bytes=1)
        assert tb.take(1)
        stop = threading.Event()
        stop.set()
        t0 = time.perf_counter()
        assert tb.take(10**6, stop) is False
        assert time.perf_counter() - t0 < 1.0

    def test_oversized_request_admits_then_charges_debt(self, side):
        tb = PKG[side]["ratelimit"].TokenBucket(10**6, burst_bytes=1000)
        assert tb.take(10**5)
        t0 = time.perf_counter()
        assert tb.take(1)
        assert time.perf_counter() - t0 > 0.05


# ---------------------------------------------------------------------------
def _tiles(nbytes=8192, seed=0, corrupt=()):
    """14 shard tiles of a seeded RS(10,4) stripe (the reference cpu
    encoder), with (sid, offset, xor) flips applied."""
    rs = ref_codec.new_encoder(backend="cpu")
    rng = np.random.default_rng(seed)
    shards = [rng.integers(0, 256, nbytes, dtype=np.uint8) for _ in range(10)] + [None] * 4
    rs.encode(shards)
    tiles = [bytearray(s.tobytes()) for s in shards]
    for sid, off, xor in corrupt:
        tiles[sid][off] ^= xor
    return [bytes(t) for t in tiles]


def _readers(tiles):
    return [lambda off, size, _t=t: _t[off: off + size] for t in tiles]


def _result(res):
    return (res.mismatch, res.bytes_per_shard, res.bad_tiles, res.culprits,
            res.unlocalized, res.end_offset, res.complete, res.aborted)


VERIFY_CASES = {
    "clean": ((), {}),
    "data": (((3, 100, 0x55),), {}),
    "parity": (((12, 5000, 0xAA),), {}),
    "two_tiles": (((3, 100, 0x55), (5, 6000, 0x10)), {}),
    "pair": (((1, 50, 0x01), (7, 60, 0x01)), {}),
    "pair_data_parity": (((4, 4000, 0x80), (13, 4001, 0x02)), {}),
    "three_unlocalized": (((1, 50, 0x01), (7, 60, 0x01), (11, 70, 0x01)), {}),
    "budget": (((2, 300, 0x03),), {"max_bytes": 4096}),
    "resume": (((2, 5000, 0x03),), {"start": 4096}),
    "no_localize": (((3, 100, 0x55),), {"localize": False}),
}


class TestVerifyCore:
    @pytest.mark.parametrize("case", sorted(VERIFY_CASES))
    def test_parity_stream_equal(self, case):
        corrupt, kw = VERIFY_CASES[case]
        tiles = _tiles(corrupt=corrupt)
        got = {
            side: _result(PKG[side]["verify"].verify_parity_stream(
                _readers(tiles), rs=PKG[side]["rs"](), tile_bytes=4096, **kw))
            for side in SIDES
        }
        assert got["ref"] == got["port"]
        mismatch, _, bad, culprits, unlocalized, _, _, _ = got["port"]
        assert bool(any(mismatch)) == bool(corrupt)
        if case in ("data", "parity", "pair", "pair_data_parity"):
            assert sorted(culprits) == sorted({sid for sid, _, _ in corrupt})
        if case == "three_unlocalized":
            assert unlocalized == 1 and not culprits

    @pytest.mark.parametrize("sids", [(3,), (12,), (1, 7), (0, 13), (10, 11), (2, 5, 9)])
    def test_localize_equal(self, sids):
        tiles = _tiles(corrupt=[(sid, 77 + sid, 0x21) for sid in sids])
        got = {side: PKG[side]["verify"].localize_corrupt_shards(tiles, PKG[side]["rs"]())
               for side in SIDES}
        assert got["ref"] == got["port"]
        assert got["port"] == (sorted(sids) if len(sids) <= 2 else None)

    def test_resume_from_cursor_matches_full_scan(self):
        tiles = _tiles()
        for side in SIDES:
            verify, rs = PKG[side]["verify"], PKG[side]["rs"]()
            full = verify.verify_parity_stream(_readers(tiles), rs=rs, tile_bytes=2048)
            part1 = verify.verify_parity_stream(_readers(tiles), rs=rs, tile_bytes=2048,
                                                max_bytes=4096)
            assert not part1.complete and part1.end_offset == 4096
            part2 = verify.verify_parity_stream(_readers(tiles), rs=rs, tile_bytes=2048,
                                                start=part1.end_offset)
            assert part2.complete
            assert part1.bytes_per_shard + part2.bytes_per_shard == full.bytes_per_shard

    def test_ecc_stream_equal(self, tmp_path):
        """The .ecc sidecar arm: a CRC pass per shard file, resumable
        mid-shard, naming a corrupt shard directly."""
        from seaweedfs_tpu_torch.util.crc import crc32c

        tiles = _tiles(nbytes=12000, corrupt=[(6, 9000, 0x40)])
        clean = _tiles(nbytes=12000)
        paths = {}
        for sid, t in enumerate(tiles):
            paths[sid] = str(tmp_path / f"9.ec{sid:02d}")
            with open(paths[sid], "wb") as f:
                f.write(t)
        doc = {"shards": {str(sid): {"size": len(t), "crc": crc32c(t)}
                          for sid, t in enumerate(clean)}}
        for kw in ({}, {"max_bytes": 20000}, {"start_shard": 6, "start_offset": 4096,
                                               "run_crc": crc32c(tiles[6][:4096])}):
            got = {}
            for side in SIDES:
                r = PKG[side]["verify"].verify_ecc_stream(paths, doc, tile_bytes=4096, **kw)
                got[side] = (r.bytes_scanned, r.bad_shards, r.shard_idx, r.offset,
                             r.run_crc, r.complete, r.aborted)
            assert got["ref"] == got["port"], kw


# ---------------------------------------------------------------------------
def _write_plain(directory, vid, n, seed, sizes=(200, 2000)):
    """One plain volume written by the reference; returns its payloads."""
    v = ref_volume.Volume(directory, vid)
    rng = random.Random(seed)
    payload = {}
    for k in range(1, n + 1):
        data = bytes(rng.randbytes(rng.randint(*sizes)))
        payload[k] = data
        v.write_needle(ref_needle.Needle(cookie=0x12345678, id=k, data=data))
    v.close()
    return payload


def _copies(tmp_path, fill):
    """fill(dir) once, then a byte-identical copy of the dir per side."""
    src = tmp_path / "src"
    src.mkdir()
    out = fill(str(src))
    dirs = {}
    for side in SIDES:
        dirs[side] = str(tmp_path / side)
        shutil.copytree(src, dirs[side])
    return dirs, out


class TestPlainScan:
    def _volumes(self, tmp_path):
        dirs, payload = _copies(tmp_path, lambda d: _write_plain(d, 7, 20, 3))
        return {side: PKG[side]["volume"].Volume(dirs[side], 7) for side in SIDES}, payload

    @staticmethod
    def _scan(side, v, **kw):
        r = PKG[side]["verify"].scan_plain_volume(v, **kw)
        return (r.scanned_bytes, [k for k, _ in r.corruptions], r.last_key, r.consumed,
                r.complete, r.aborted)

    def test_clean_scan(self, tmp_path):
        vols, payload = self._volumes(tmp_path)
        got = {side: self._scan(side, v) for side, v in vols.items()}
        assert got["ref"] == got["port"]
        assert got["port"][4] and not got["port"][1]
        assert got["port"][0] > sum(len(d) for d in payload.values())
        for v in vols.values():
            v.close()

    def test_detects_flipped_data_byte(self, tmp_path):
        vols, _ = self._volumes(tmp_path)
        for v in vols.values():
            corrupt_needle_data(v, 11)
        got = {side: (self._scan(side, v), self._scan(side, v, after_key=11))
               for side, v in vols.items()}
        assert got["ref"] == got["port"]
        assert got["port"][0][1] == [11] and not got["port"][1][1]
        for v in vols.values():
            v.close()

    def test_budget_partial_then_resume(self, tmp_path):
        vols, _ = self._volumes(tmp_path)
        got = {}
        for side, v in vols.items():
            part = self._scan(side, v, max_bytes=2000)
            got[side] = (part, self._scan(side, v, after_key=part[2]))
        assert got["ref"] == got["port"]
        assert not got["port"][0][4] and got["port"][1][4]
        for v in vols.values():
            v.close()


# ---------------------------------------------------------------------------
def _ec_fill(n_needles=40, vid=9):
    def fill(d):
        payload = _write_plain(d, vid, n_needles, 5, sizes=(500, 4000))
        ref_ec_files.write_ec_files(os.path.join(d, str(vid)), rs=ref_codec.new_encoder(backend="cpu"))
        ref_ec_files.write_sorted_file_from_idx(os.path.join(d, str(vid)))
        os.remove(os.path.join(d, f"{vid}.dat"))
        os.remove(os.path.join(d, f"{vid}.idx"))
        return payload
    return fill


def _ec_stores(tmp_path, damage=None):
    """One EC volume (encoded by the reference, all 14 shards local),
    copied per side, `damage(dir)` applied to each copy, mounted by each
    package's Store."""
    dirs, payload = _copies(tmp_path, _ec_fill())
    stores = {}
    for side in SIDES:
        if damage is not None:
            damage(dirs[side])
        stores[side] = PKG[side]["store"].Store([dirs[side]], **PKG[side]["store_kw"])
        assert stores[side].find_ec_volume(9) is not None
    return dirs, stores, payload


def _state(directory):
    with open(os.path.join(directory, "scrub_state.json")) as f:
        rows = json.load(f)["volumes"]
    for row in rows:
        for name in WALL_CLOCK_FIELDS:
            row.pop(name)
    return sorted(rows, key=lambda r: (r["volume_id"], r["is_ec"]))


def _files(directory):
    return sorted(n for n in os.listdir(directory) if not n.startswith("scrub_state"))


class TestScrubEngine:
    def _sweep_both(self, tmp_path, damage=None, **engine_kw):
        dirs, stores, payload = _ec_stores(tmp_path, damage)
        events = {side: [] for side in SIDES}
        summaries, engines = {}, {}
        for side in SIDES:
            engines[side] = PKG[side]["engine"].ScrubEngine(
                stores[side], interval=3600, rate_mb_s=0,
                on_event=lambda s=side: events[s].append(1), **engine_kw)
            summaries[side] = engines[side].sweep_once()
        assert summaries["ref"] == summaries["port"]
        assert _state(dirs["ref"]) == _state(dirs["port"])
        assert _files(dirs["ref"]) == _files(dirs["port"])
        assert len(events["ref"]) == len(events["port"])
        return dirs, stores, engines, summaries["port"], payload

    def test_clean_sweep_and_state_persistence(self, tmp_path):
        dirs, stores, _, summary, _ = self._sweep_both(tmp_path)
        assert summary["ec_volumes"] == 1 and summary["corruptions"] == 0
        assert summary["scanned_bytes"] > 0
        for side in SIDES:
            again = PKG[side]["engine"].ScrubEngine(stores[side], interval=3600, rate_mb_s=0)
            rows = again.health_rows()
            assert rows and rows[0].sweeps == 1
            stores[side].close()

    @pytest.mark.parametrize("sid", [2, 11])
    def test_detects_quarantines_and_renames(self, tmp_path, sid):
        dirs, stores, _, summary, _ = self._sweep_both(
            tmp_path, damage=lambda d: flip_byte(os.path.join(d, f"9.ec{sid:02d}"), 300, 0x40))
        assert summary["corruptions"] >= 1 and summary["quarantined"] == 1
        for side in SIDES:
            ev = stores[side].find_ec_volume(9)
            assert sid not in ev.shards and sid in ev.quarantined
            assert stores[side].quarantined[9][sid].startswith("scrub:")
            assert stores[side].quarantined_shard_bits(9) == 1 << sid
            assert os.path.exists(os.path.join(dirs[side], f"9.ec{sid:02d}.bad"))
            stores[side].close()

    def test_truncated_shard_quarantined_by_sweep(self, tmp_path):
        dirs, stores, _, _, _ = self._sweep_both(
            tmp_path, damage=lambda d: truncate_by(
                os.path.join(d, "9.ec05"), os.path.getsize(os.path.join(d, "9.ec05")) - 64))
        for side in SIDES:
            ev = stores[side].find_ec_volume(9)
            assert 5 not in ev.shards and 5 in ev.quarantined
            stores[side].close()

    def test_rebuild_after_quarantine_restores_reads(self, tmp_path):
        dirs, stores, engines, _, payload = self._sweep_both(
            tmp_path, damage=lambda d: flip_byte(os.path.join(d, "9.ec02"), 300, 0x40))
        for side in SIDES:
            rebuilt = PKG[side]["ec_files"].rebuild_ec_files(
                os.path.join(dirs[side], "9"), rs=PKG[side]["rs"]())
            assert rebuilt == [2]
            stores[side].mount_ec_shards(9, "", [2])
            ev = stores[side].find_ec_volume(9)
            assert 2 in ev.shards and 2 not in ev.quarantined
            for k, data in payload.items():
                assert bytes(ev.read_needle(k).data) == data
            assert engines[side].sweep_once()["corruptions"] == 0
        assert _state(dirs["ref"]) == _state(dirs["port"])
        with open(os.path.join(dirs["ref"], "9.ec02"), "rb") as a, \
                open(os.path.join(dirs["port"], "9.ec02"), "rb") as b:
            assert a.read() == b.read()
        for store in stores.values():
            store.close()

    def test_plain_volume_corruption_reported_not_quarantined(self, tmp_path):
        dirs, _ = _copies(tmp_path, lambda d: _write_plain(d, 4, 14, 7, sizes=(1200, 1200)))
        rows = {}
        for side in SIDES:
            store = PKG[side]["store"].Store([dirs[side]], **PKG[side]["store_kw"])
            corrupt_needle_data(store.find_volume(4), 7)
            eng = PKG[side]["engine"].ScrubEngine(store, interval=3600, rate_mb_s=0)
            assert eng.sweep_once()["corruptions"] == 1
            h = next(r for r in eng.health_rows() if r.volume_id == 4)
            assert h.sweep_corruptions == 1 and "needle 7" in h.last_error
            rows[side] = _state(dirs[side])
            store.close()
        assert rows["ref"] == rows["port"]

    def test_segmented_sweep_resumes_like_the_reference(self, tmp_path, monkeypatch):
        """Small segments and tiles: the engine persists its cursor per
        segment; both packages walk the same segments."""
        for side in SIDES:
            monkeypatch.setattr(PKG[side]["engine"], "SEGMENT_BYTES", 8192)
        self._sweep_both(tmp_path, damage=lambda d: flip_byte(
            os.path.join(d, "9.ec07"), 9000, 0x08), tile_bytes=4096)


# ---------------------------------------------------------------------------
# live mini-cluster, one per package: the acceptance loop, no manual shell command
def _cluster(side, tmp_path_factory, n, racks, scrub_interval=1.0, **master_kw):
    from seaweedfs_tpu.server.master_server import MasterServer as RefMaster
    from seaweedfs_tpu.server.volume_server import VolumeServer as RefVolume
    from seaweedfs_tpu_torch.server.master_server import MasterServer as PortMaster
    from seaweedfs_tpu_torch.server.volume_server import VolumeServer as PortVolume
    from seaweedfs_tpu_torch.util.availability import free_port

    Master, Volume = (RefMaster, RefVolume) if side == "ref" else (PortMaster, PortVolume)
    codec = dict(ec_codec="cpu") if side == "ref" else dict(ec_codec="cuda", device="cpu")
    master = Master(port=free_port(), volume_size_limit_mb=64, vacuum_interval=0,
                    repair_interval=0.5, repair_grace=0.5, **master_kw)
    master.repair.cooldown = 3.0
    master.start()
    servers = []
    try:
        for i in range(n):
            vs = Volume([str(tmp_path_factory.mktemp(f"{side}-heal{i}"))], port=free_port(),
                        master=f"127.0.0.1:{master.port}", rack=racks[i],
                        heartbeat_interval=0.2, max_volume_counts=[100],
                        scrub_interval=scrub_interval, scrub_rate_mb_s=0, **codec)
            vs.start()
            servers.append(vs)
        assert wait_for(lambda: len(master.topology.data_nodes()) == n, 45)
    except BaseException:
        for vs in servers:
            vs.stop()
        master.stop()
        raise
    return master, servers


@pytest.fixture(scope="module", params=SIDES)
def healing_cluster(request, tmp_path_factory):
    # sweeps only when a test triggers one: a sweep that runs while
    # ec.encode spreads the shards can cache the encoding server itself
    # as the holder of a shard it is giving away, and the reference's
    # fetcher then never reaches that shard within the cache's TTL, so
    # that server's passes stop and it never quarantines its own
    # culprit (ROADMAP Queue 3; TestStaleSelfLocation holds the port's
    # repair)
    master, servers = _cluster(request.param, tmp_path_factory, 3,
                               ["rack0", "rack1", "rack0"], scrub_interval=3600.0)
    yield request.param, master, servers
    for vs in servers:
        vs.stop()
    master.stop()


def _registered_shards(master, vid):
    locs = master.topology.lookup_ec_shards(vid)
    if locs is None:
        return 0
    return sum(1 for nodes in locs.locations if nodes)


def _shell(side):
    if side == "ref":
        from seaweedfs_tpu.shell import command_env, commands
    else:
        from seaweedfs_tpu_torch.shell import command_env, commands
    return command_env, commands


class TestSelfHealingEndToEnd:
    def test_corrupt_shard_detected_quarantined_rebuilt(self, healing_cluster):
        from seaweedfs_tpu_torch.util.availability import write_keyset

        side, master, servers = healing_cluster
        command_env, commands = _shell(side)
        vid, keys, _src = write_keyset(
            master.port, "heal", n=10,
            payload_fn=lambda i: (f"heal {i} ".encode() * 2500)[: 16000 + i])
        env = command_env.CommandEnv([f"127.0.0.1:{master.port}"])
        commands.do_ec_encode(env, vid, "heal", io.StringIO())
        assert wait_for(lambda: _registered_shards(master, vid) == 14, 20)
        wait_for(lambda: not master.repair.tasks, 30)

        shard_path, holder = find_ec_shard_path(servers, "heal", vid, 3)
        assert shard_path is not None
        with open(shard_path, "rb") as f:
            original = f.read()
        flip_byte(shard_path, 500, 0x77)
        holder.scrub.trigger(vid)
        assert wait_for(lambda: 3 in holder.store.quarantined.get(vid, {}), 30), \
            "background scrubber never quarantined the corrupt shard"
        assert os.path.exists(shard_path + ".bad")
        assert wait_for(lambda: any(h["Kind"] == "ec_rebuild" and h["VolumeId"] == vid
                                    for h in master.repair.history), 90), \
            f"no ec_rebuild recorded: {master.repair.queue_snapshot()}"
        assert wait_for(lambda: _registered_shards(master, vid) == 14 and any(
            (ev := s.store.find_ec_volume(vid)) is not None and 3 in ev.shards
            for s in servers), 30), "cluster never converged to 14 mounted+registered shards"
        rebuilt = next(s.store.find_ec_volume(vid).shards[3].path for s in servers
                       if s.store.find_ec_volume(vid) is not None
                       and 3 in s.store.find_ec_volume(vid).shards)
        with open(rebuilt, "rb") as f:
            assert f.read() == original
        for fid, want in keys.items():
            with urllib.request.urlopen(
                    f"http://127.0.0.1:{master.port}/{fid}?collection=heal", timeout=10) as r:
                assert r.read() == want

        # ec.verify through the scrub core: the port's (K1's plain
        # version) and the reference's agree on this cluster's shards
        reports = {}
        for verifier in SIDES:
            v_env, v_cmds = _shell(verifier)
            out = io.StringIO()
            kw = {} if verifier == "ref" else {
                "rs": port_codec.new_encoder(backend="cuda", device="cpu")}
            assert v_cmds.do_ec_verify(v_env.CommandEnv([f"127.0.0.1:{master.port}"]),
                                       vid, out, as_json=True, **kw) == [0, 0, 0, 0]
            reports[verifier] = json.loads(out.getvalue())
        assert reports["ref"] == reports["port"]
        assert reports["port"]["corrupt"] is False and reports["port"]["volumeId"] == vid

    def test_ec_verify_names_a_corrupt_shard_alike(self, healing_cluster):
        """A flipped byte in one parity shard, before any sweep sees it:
        both packages' ec.verify report the same rows and culprit."""
        from seaweedfs_tpu_torch.util.availability import write_keyset

        side, master, servers = healing_cluster
        command_env, commands = _shell(side)
        vid, _keys, _src = write_keyset(
            master.port, "verify", n=6,
            payload_fn=lambda i: (f"verify {i} ".encode() * 900)[: 7000 + i])
        env = command_env.CommandEnv([f"127.0.0.1:{master.port}"])
        commands.do_ec_encode(env, vid, "verify", io.StringIO())
        assert wait_for(lambda: _registered_shards(master, vid) == 14, 20)
        shard_path, _holder = find_ec_shard_path(servers, "verify", vid, 12)
        for s in servers:  # no sweep may quarantine it while we look
            s.scrub.sweep_once = lambda: {}
        assert wait_for(lambda: not any(s.scrub.sweep_running for s in servers), 30)
        flip_byte(shard_path, 40, 0x01)
        reports = {}
        for verifier in SIDES:
            v_env, v_cmds = _shell(verifier)
            out = io.StringIO()
            kw = {} if verifier == "ref" else {
                "rs": port_codec.new_encoder(backend="cuda", device="cpu")}
            v_cmds.do_ec_verify(v_env.CommandEnv([f"127.0.0.1:{master.port}"]),
                                vid, out, as_json=True, **kw)
            reports[verifier] = json.loads(out.getvalue())
        flip_byte(shard_path, 40, 0x01)  # restore
        for s in servers:
            del s.scrub.sweep_once
        assert reports["ref"] == reports["port"]
        assert reports["port"]["culpritShards"] == [12]
        assert reports["port"]["mismatchPerParityRow"][2] == 1

    def test_quarantine_reaches_master_and_status_json(self, healing_cluster):
        from seaweedfs_tpu_torch.util.availability import write_keyset

        side, master, servers = healing_cluster
        command_env, commands = _shell(side)
        vid, keys, _src = write_keyset(
            master.port, "quiet", n=8,
            payload_fn=lambda i: (f"quiet {i} ".encode() * 2000)[: 12000 + i])
        env = command_env.CommandEnv([f"127.0.0.1:{master.port}"])
        commands.do_ec_encode(env, vid, "quiet", io.StringIO())
        assert wait_for(lambda: _registered_shards(master, vid) == 14, 20)
        shard_path, holder = find_ec_shard_path(servers, "quiet", vid, 1)
        truncate_by(shard_path, os.path.getsize(shard_path) - 100)
        fid = next(iter(keys))
        with urllib.request.urlopen(f"http://{holder.host}:{holder.port}/{fid}",
                                    timeout=10) as r:
            assert r.read() == keys[fid]
        assert wait_for(lambda: vid in holder.store.quarantined
                        or _registered_shards(master, vid) == 14, 30)
        with urllib.request.urlopen(f"http://{holder.host}:{holder.port}/status",
                                    timeout=5) as r:
            st = json.loads(r.read())
        assert "QuarantinedShards" in st and "Scrub" in st
        assert not st["Scrub"].get("Disabled")
        assert wait_for(lambda: _registered_shards(master, vid) == 14, 60)

    def test_repair_queue_and_scrub_shell_surfaces(self, healing_cluster):
        side, master, _servers = healing_cluster
        command_env, commands = _shell(side)
        env = command_env.CommandEnv([f"127.0.0.1:{master.port}"])
        snap = json.loads(commands.run_command(env, "repair.queue -json"))
        assert "Config" in snap and snap["Config"]["Concurrency"] == 2
        assert "sweeps" in commands.run_command(env, "scrub.status")
        assert "sweep triggered" in commands.run_command(env, "scrub.trigger")
        with urllib.request.urlopen(f"http://127.0.0.1:{master.port}/repair/queue",
                                    timeout=5) as r:
            assert set(json.loads(r.read())) == set(snap)


# ---------------------------------------------------------------------------
class TestPlainReplicaReplace:
    @pytest.mark.parametrize("side", SIDES)
    def test_corrupt_replica_replaced_from_clean_peer(self, side, tmp_path_factory):
        """Plain-volume self-healing: scrub flags a CRC-corrupt replica;
        the scheduler deletes it and re-copies from the clean peer; reads
        on the repaired node are byte-identical."""
        from seaweedfs_tpu_torch.util.availability import write_keyset

        master, servers = _cluster(side, tmp_path_factory, 2, ["rack0", "rack0"])
        try:
            vid, keys, _src = write_keyset(
                master.port, "repl", n=10,
                payload_fn=lambda i: (f"repl {i} ".encode() * 800)[: 5000 + i])
            holders = [vs for vs in servers if vs.store.find_volume(vid) is not None]
            assert len(holders) == 2, "replication=001 should place 2 copies"
            bad = holders[0]
            v = bad.store.find_volume(vid)
            live = sorted(nv.key for nv in v.nm.items())
            corrupt_needle_data(v, live[0])
            swept = bad.scrub.sweeps_completed
            bad.scrub.trigger(vid)
            assert wait_for(lambda: bad.scrub.sweeps_completed > swept, 30), \
                "triggered scrub sweep never completed (detection stage)"
            assert wait_for(lambda: (v2 := bad.store.find_volume(vid)) is not None
                            and v2 is not v, 90), \
                "replace repair never recreated the corrupt replica"
            assert wait_for(lambda: any(h["Kind"] == "replace"
                                        for h in master.repair.history), 30)
            v2 = bad.store.find_volume(vid)
            assert v2.read_needle(live[0]) is not None
            for fid, want in keys.items():
                with urllib.request.urlopen(f"http://{bad.host}:{bad.port}/{fid}",
                                            timeout=10) as r:
                    assert r.read() == want
        finally:
            for vs in servers:
                vs.stop()
            master.stop()


class TestStaleSelfLocation:
    @pytest.mark.parametrize("cached", ["self", "none"])
    def test_sweep_fetcher_relearns_a_shard_not_held_here(self, healing_cluster, cached):
        """A server whose cached location of a shard it does not mount
        names only itself, or nothing (it quarantined the shard, or met
        it quarantined elsewhere, and a rebuild put it on another
        server): the port's scrub fetcher asks the master again and
        reads the shard; the reference's engine fetches through
        _remote_shard_fetcher, which skips itself, forgets nothing and
        fails until the cache's TTL (ROADMAP Queue 3). The same setup on
        each side."""
        import time as _time

        from seaweedfs_tpu_torch.util.availability import write_keyset

        side, master, servers = healing_cluster
        command_env, commands = _shell(side)
        vid, _keys, _src = write_keyset(
            master.port, f"stale{cached}", n=6,
            payload_fn=lambda i: (f"stale {i} ".encode() * 900)[: 7000 + i])
        commands.do_ec_encode(command_env.CommandEnv([f"127.0.0.1:{master.port}"]),
                              vid, f"stale{cached}", io.StringIO())
        assert wait_for(lambda: _registered_shards(master, vid) == 14, 20)
        server = next(s for s in servers if s.store.find_ec_volume(vid) is not None
                      and len(s.store.find_ec_volume(vid).shards) < 14)
        ev = server.store.find_ec_volume(vid)
        sid = next(i for i in range(14) if i not in ev.shards)
        shard_path, _holder = find_ec_shard_path(servers, f"stale{cached}", vid, sid)
        with open(shard_path, "rb") as f:
            want = f.read(4096)
        with ev.shard_locations_lock:
            for i in range(14):
                if i in ev.shards:
                    continue
                if cached == "self":
                    ev.shard_locations[i] = [f"{server.host}:{server.port}"]
                else:
                    ev.shard_locations.pop(i, None)
            ev.shard_locations_refresh_time = _time.time()
        if side == "port":
            assert server._scrub_shard_fetcher(ev)(sid, 0, 4096) == want
        else:
            # the reference's fault, held
            assert server._remote_shard_fetcher(ev)(sid, 0, 4096) is None
