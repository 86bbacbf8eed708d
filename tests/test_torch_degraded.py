"""The port's degraded-read fast path and repair piggyback, on the CPU:
tests/test_ec_degraded.py's TestTileCache, TestFirstKGather,
TestDegradedRead and TestRepairSession against seaweedfs_tpu_torch.

Volumes are written with the port's storage code, encoded on its numpy
backend, and opened with EcVolume.load (the port has no Store yet); the
EcVolume decodes through its cuda backend with device="cpu", i.e. K1's
plain version. Where the reference's modules are pure host code the
port's copies are also held against them on the same inputs.
TestDegradedServingEndToEnd runs on each package's own cluster (a
master and three volume servers), the port's on the cuda backend with
device="cpu".
"""

import inspect
import os
import random
import shutil
import sys
import threading
import time
from pathlib import Path

import pytest

from seaweedfs_tpu.ec import repair_session as ref_session
from seaweedfs_tpu.ec.tile_cache import TileCache as RefTileCache
from seaweedfs_tpu_torch import trace
from seaweedfs_tpu_torch.ec import ec_files, ec_stream, ec_volume, repair_session
from seaweedfs_tpu_torch.ec.codec import new_encoder
from seaweedfs_tpu_torch.ec.ec_volume import EcVolume, NotEnoughShards
from seaweedfs_tpu_torch.ec.tile_cache import TileCache
from seaweedfs_tpu_torch.qos import hedge
from seaweedfs_tpu_torch.qos.singleflight import SingleFlight
from seaweedfs_tpu_torch.stats.metrics import (
    EC_DEGRADED_READS,
    EC_REPAIR_BYTES_READ,
    EC_REPAIR_BYTES_WRITTEN,
    EC_REPAIR_DONATED_BYTES,
    EC_TILE_CACHE,
)
from seaweedfs_tpu_torch.storage.needle import Needle
from seaweedfs_tpu_torch.storage.synthetic import write_volume

REPO = Path(__file__).resolve().parents[1]
if str(REPO) not in sys.path:
    sys.path.insert(0, str(REPO))


def _local_ec_volume(tmp_path, nbytes=120_000, vid=9, seed=5):
    """An EC volume of small needles (all in shard 0's first block),
    the .dat and .idx removed; returns (EcVolume, {id: data})."""
    d = str(tmp_path)
    base = os.path.join(d, str(vid))
    _, entries = write_volume(base, nbytes, seed, max_payload=4000)
    ec_files.write_ec_files(base, rs=new_encoder(backend="cpu"))
    ec_files.write_sorted_file_from_idx(base)
    payload = {}
    with open(base + ".dat", "rb") as f:
        for nid, off, size in entries:
            f.seek(off)
            payload[nid] = bytes(Needle.from_bytes(f.read(16 + size + 12), 3, size).data)
    os.remove(base + ".dat")
    os.remove(base + ".idx")
    return EcVolume.load(d, vid, backend="cuda", device="cpu"), payload


def _tile_counts():
    return EC_TILE_CACHE.value("hit"), EC_TILE_CACHE.value("miss")


# ---------------------------------------------------------------------------
class TestTileCache:
    def test_lru_eviction_bounds_bytes(self):
        c = TileCache(capacity_bytes=3 * 100, tile_bytes=4096)
        for i in range(10):
            c.put(0, i * 4096, bytes([i]) * 100)
            assert c.total_bytes <= 300
        # the oldest tiles were evicted, the newest survive
        assert c.get(0, 9 * 4096) is not None
        assert c.get(0, 0) is None

    def test_get_touches_lru_order(self):
        c = TileCache(capacity_bytes=2 * 100, tile_bytes=4096)
        c.put(0, 0, b"a" * 100)
        c.put(0, 4096, b"b" * 100)
        assert c.get(0, 0) is not None  # touch: 0 is now most-recent
        c.put(0, 8192, b"c" * 100)  # evicts 4096, not 0
        assert c.get(0, 0) is not None
        assert c.get(0, 4096) is None

    def test_covers_spans_and_partial_tail(self):
        c = TileCache(capacity_bytes=1 << 20, tile_bytes=4096)
        c.put(3, 0, b"x" * 4096)
        c.put(3, 4096, b"y" * 1000)  # short tail tile
        assert c.covers(3, 100, 200)
        assert c.covers(3, 4000, 200)  # crosses into the tail tile
        assert c.covers(3, 4096, 1000)
        assert not c.covers(3, 4096, 2000)  # beyond the cached tail
        assert not c.covers(3, 8192, 1)
        assert not c.covers(4, 0, 1)  # other shard

    def test_env_kill_switch(self, monkeypatch):
        monkeypatch.setenv("WEED_EC_TILE_CACHE", "0")
        c = TileCache()
        assert not c.enabled
        c.put(0, 0, b"z" * 10)
        assert c.get(0, 0) is None

    def test_invalidate_drops_everything(self):
        c = TileCache(capacity_bytes=1 << 20, tile_bytes=4096)
        c.put(0, 0, b"x" * 50)
        c.invalidate()
        assert c.total_bytes == 0
        assert c.get(0, 0) is None
        assert c.invalidations == 1

    def test_stale_generation_put_is_dropped(self):
        c = TileCache(capacity_bytes=1 << 20, tile_bytes=4096)
        gen = c.invalidations
        c.invalidate()  # a quarantine raced the decode
        assert not c.put(0, 0, b"x" * 10, gen=gen)
        assert c.put(0, 0, b"x" * 10, gen=c.invalidations)

    @pytest.mark.parametrize("env", [
        {}, {"WEED_EC_TILE_CACHE_MB": "1", "WEED_EC_TILE_BYTES": "65536"},
        {"WEED_EC_TILE_SCAN": "0"}, {"WEED_EC_TILE_BYTES": "junk"},
    ], ids=["default", "sized", "no_scan", "junk"])
    def test_knobs_and_segments_match_reference(self, monkeypatch, env):
        """Same knobs, same admission/promotion/eviction as the
        reference's cache on one random op sequence."""
        for k, v in env.items():
            monkeypatch.setenv(k, v)
        port, ref = TileCache(), RefTileCache()
        for attr in ("capacity_bytes", "tile_bytes", "scan_resistant",
                     "probation_bytes_cap", "enabled"):
            assert getattr(port, attr) == getattr(ref, attr), attr
        small = (TileCache(capacity_bytes=16 * 4096, tile_bytes=4096),
                 RefTileCache(capacity_bytes=16 * 4096, tile_bytes=4096))
        rng = random.Random(3)
        for _ in range(600):
            sid, off = rng.randrange(3), rng.randrange(40) * 4096
            op = rng.random()
            if op < 0.5:
                data = bytes([off % 251]) * rng.choice((4096, 100))
                assert small[0].put(sid, off, data) == small[1].put(sid, off, data)
            elif op < 0.95:
                assert small[0].get(sid, off) == small[1].get(sid, off)
            else:
                small[0].invalidate()
                small[1].invalidate()
            assert small[0].total_bytes == small[1].total_bytes
        for sid in range(3):
            assert sorted(small[0].snapshot(sid)) == sorted(small[1].snapshot(sid))


# ---------------------------------------------------------------------------
class TestFirstKGather:
    def test_first_k_wins_does_not_wait_for_stragglers(self):
        def fast(tag):
            return lambda done: tag

        def slow(done):
            time.sleep(3.0)
            return "slow"

        t0 = time.perf_counter()
        got = hedge.gather_first_k(
            {"a": fast("a"), "b": fast("b"), "z": slow}, 2, timeout=10.0
        )
        elapsed = time.perf_counter() - t0
        assert set(got) == {"a", "b"}
        assert elapsed < 2.0, "gather blocked on the straggler"

    def test_failures_and_nones_are_misses(self):
        def boom(done):
            raise OSError("down")

        got = hedge.gather_first_k(
            {"x": boom, "y": lambda done: None, "z": lambda done: 7},
            2,
            timeout=5.0,
        )
        assert got == {"z": 7}

    def test_done_event_set_after_k(self):
        saw = {}

        def task(tag):
            def run(done):
                saw[tag] = done
                return tag

            return run

        got = hedge.gather_first_k({1: task(1), 2: task(2)}, 1, timeout=5.0)
        assert len(got) == 1
        deadline = time.time() + 2.0
        while time.time() < deadline and not all(
            d.is_set() for d in saw.values()
        ):
            time.sleep(0.01)
        assert all(d.is_set() for d in saw.values())

    def test_attempt_workers_are_recycled(self):
        hedge.gather_first_k({i: (lambda done, i=i: i) for i in range(4)}, 4)
        time.sleep(0.05)  # let the workers park
        before = hedge._ATTEMPTS.spawned
        for _ in range(30):
            assert len(hedge.gather_first_k({0: lambda done: 1}, 1)) == 1
        assert hedge._ATTEMPTS.spawned - before <= 2

    def test_close_idle_ends_parked_workers_and_tasks_are_dropped(self):
        """A parked worker holds nothing of its last task, close_idle()
        ends every parked worker (a volume server's stop() calls it), and
        the next gather starts fresh ones."""
        import gc
        import weakref

        class Payload:
            pass

        held = Payload()
        ref = weakref.ref(held)
        assert hedge.gather_first_k({0: lambda done, h=held: 1}, 1) == {0: 1}
        del held
        deadline = time.time() + 2.0
        while time.time() < deadline and ref() is not None:
            gc.collect()
            time.sleep(0.01)
        assert ref() is None
        pool = hedge._ATTEMPTS
        with pool._lock:
            parked = [pool._threads[q] for q in pool._idle]
        assert parked
        hedge.close_idle()
        assert not any(t.is_alive() for t in parked) and not pool._idle
        assert hedge.gather_first_k({1: lambda done: 2}, 1) == {1: 2}

    def test_zero_k_or_no_tasks(self):
        assert hedge.gather_first_k({}, 3) == {}
        assert hedge.gather_first_k({1: lambda done: 1}, 0) == {}


class TestSingleFlight:
    def test_lead_wait_release(self):
        sf = SingleFlight()
        lease = sf.lead("k")
        assert lease is not None and sf.lead("k") is None
        assert sf.inflight() == 1
        woke = []
        t = threading.Thread(target=lambda: woke.append(sf.wait("k", timeout=5)))
        t.start()
        sf.release("k", lease)
        t.join(5)
        assert woke == [True] and sf.inflight() == 0
        assert sf.wait("k") is True  # no leader: probe and self-serve

    def test_stale_release_keeps_successor(self):
        sf = SingleFlight()
        first = sf.lead("k")
        sf.release("k", first)
        second = sf.lead("k")
        sf.release("k", first)  # late release of the old lease
        assert sf.lead("k") is None and sf.inflight() == 1
        sf.release("k", second)
        assert sf.inflight() == 0


# ---------------------------------------------------------------------------
class TestDegradedRead:
    def test_cached_vs_fresh_byte_identity(self, tmp_path):
        ev, payload = _local_ec_volume(tmp_path)
        assert ev.quarantine_shard(0, "test")
        h0, m0 = _tile_counts()
        d0 = EC_DEGRADED_READS.value()
        fresh = {k: bytes(ev.read_needle(k).data) for k in payload}
        h1, m1 = _tile_counts()
        assert m1 > m0, "first pass must decode at least one tile"
        cached = {k: bytes(ev.read_needle(k).data) for k in payload}
        h2, m2 = _tile_counts()
        assert m2 == m1, "second pass must be all cache hits"
        assert h2 > h1
        assert EC_DEGRADED_READS.value() > d0
        for k in payload:
            assert fresh[k] == payload[k] == cached[k]
        ev.close()

    def test_remount_invalidates_cache(self, tmp_path):
        ev, payload = _local_ec_volume(tmp_path)
        ev.quarantine_shard(0, "test")
        for k in list(payload)[:5]:
            ev.read_needle(k)
        assert ev.tile_cache.total_bytes > 0
        inv0 = ev.tile_cache.invalidations
        # rebuild regenerates the .bad-renamed shard; remount must drop
        # every cached tile (they were decoded against the old state)
        rebuilt = ec_files.rebuild_ec_files(
            os.path.join(str(tmp_path), "9"), rs=new_encoder(backend="cpu")
        )
        assert rebuilt == [0]
        ev.mount_shard(0)
        assert 0 not in ev.quarantined
        assert ev.tile_cache.total_bytes == 0
        assert ev.tile_cache.invalidations > inv0
        for k, data in payload.items():
            assert bytes(ev.read_needle(k).data) == data
        ev.close()

    def test_bounded_memory_under_concurrent_readers(self, tmp_path):
        ev, payload = _local_ec_volume(tmp_path, nbytes=180_000)
        ev.quarantine_shard(0, "test")
        # tiny tiles + a 3-tile budget: concurrent misses must never
        # blow past the cap even while every thread is inserting
        ev.tile_cache = TileCache(capacity_bytes=3 * 8192, tile_bytes=8192)
        errors: list = []
        peak = [0]

        def reader(seed):
            rng = random.Random(seed)
            try:
                for _ in range(30):
                    k = rng.choice(list(payload))
                    got = bytes(ev.read_needle(k).data)
                    if got != payload[k]:
                        raise AssertionError(f"needle {k} corrupt")
                    peak[0] = max(peak[0], ev.tile_cache.total_bytes)
            except Exception as e:  # noqa: BLE001
                errors.append(e)

        threads = [threading.Thread(target=reader, args=(i,)) for i in range(8)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(60)
        assert not errors, errors[:2]
        assert peak[0] <= 3 * 8192
        ev.close()

    def test_gather_uses_fetch_for_unmounted_survivors(self, tmp_path):
        ev, payload = _local_ec_volume(tmp_path)
        ev.quarantine_shard(0, "test")
        # unmount four healthy shards: 9 locals remain, the gather must
        # race the "remote" candidates through the attempt pool
        paths = {sid: ev.shards[sid].path for sid in (1, 2, 3, 4)}
        for sid in paths:
            ev.unmount_shard(sid)
        fetched: list[int] = []

        def fetch(sid, offset, size):
            p = paths.get(sid)
            if p is None:
                return None
            fetched.append(sid)
            with open(p, "rb") as f:
                f.seek(offset)
                return f.read(size)

        for k, data in payload.items():
            assert bytes(ev.read_needle(k, fetch=fetch).data) == data
        assert fetched, "remote fetch never used despite missing locals"
        ev.close()

    def test_singleflight_one_decode_per_hot_tile(self, tmp_path):
        """8 concurrent degraded GETs of one cold hot key must collapse
        to (about) one k-shard gather + decode, not fan out 8."""
        ev, payload = _local_ec_volume(tmp_path)
        ev.quarantine_shard(0, "test")
        calls: list[int] = []
        orig = ev._reconstruct_range

        def counting(*a, **kw):
            calls.append(1)
            time.sleep(0.05)  # widen the would-be stampede window
            return orig(*a, **kw)

        ev._reconstruct_range = counting
        hot = next(iter(payload))
        errors: list = []

        def read():
            try:
                assert bytes(ev.read_needle(hot).data) == payload[hot]
            except Exception as e:  # noqa: BLE001
                errors.append(e)

        threads = [threading.Thread(target=read) for _ in range(8)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(30)
        assert not errors, errors[:2]
        # one leader per tile the needle spans (2 allows a boundary
        # needle); without singleflight this is 8+
        assert len(calls) <= 2, f"{len(calls)} concurrent decodes"
        ev.close()

    def test_not_enough_shards_raises(self, tmp_path):
        ev, payload = _local_ec_volume(tmp_path)
        for sid in range(5):  # 9 survivors < k=10
            ev.quarantine_shard(sid, "test")
        with pytest.raises(NotEnoughShards):
            ev.read_needle(next(iter(payload)))
        ev.close()

    def test_serial_fallback_gone_from_hot_path(self):
        # the per-call ThreadPoolExecutor gather must never come back
        src = inspect.getsource(ec_volume)
        assert "ThreadPoolExecutor" not in src
        assert "as_completed" not in src

    def test_quarantine_renames_and_reports(self, tmp_path):
        ev, payload = _local_ec_volume(tmp_path)
        path = ev.shards[2].path
        assert ev.quarantine_shard(2, "scrub crc")
        assert not ev.quarantine_shard(2, "again")  # already gone
        assert ev.quarantined == {2: "scrub crc"} and 2 not in ev.shard_ids()
        assert not os.path.exists(path) and os.path.exists(path + ".bad")
        for k, data in payload.items():
            assert bytes(ev.read_needle(k).data) == data
        ev.close()

    def test_degraded_span_carries_gather_and_decode_stages(self, tmp_path):
        ev, payload = _local_ec_volume(tmp_path)
        ev.quarantine_shard(0, "test")
        before = trace.totals("ec.degraded")
        for k, data in payload.items():
            assert bytes(ev.read_needle(k).data) == data
        after = trace.totals("ec.degraded")
        assert after["count"] > before["count"]
        assert after["bytes"] > before["bytes"]
        gather = after["stages"]["gather"] - before["stages"].get("gather", 0.0)
        decode = after["stages"]["decode"] - before["stages"].get("decode", 0.0)
        assert gather > 0 and decode > 0
        assert gather + decode <= after["seconds"] - before["seconds"]
        last = trace.recent(1)[0]
        assert last["name"] == "ec.degraded" and last["plane"] == "serve"
        assert set(last["stages_ms"]) == {"gather", "decode"}
        ev.close()

    def test_decode_runs_take_one_decode_per_run(self, tmp_path):
        """A cold span over several tiles is one gather + decode, and
        its tiles land in the cache (the run path)."""
        ev, _ = _local_ec_volume(tmp_path)
        ev.quarantine_shard(0, "test")
        ev.tile_cache = TileCache(capacity_bytes=1 << 20, tile_bytes=8192)
        calls = []
        orig = ev._reconstruct_range
        ev._reconstruct_range = lambda *a: calls.append(a) or orig(*a)
        got = ev._reconstruct_interval(0, 1000, 5 * 8192, None)
        assert calls == [(0, 0, 6 * 8192, None)]  # tiles 0..5, one run
        assert len(ev.tile_cache.snapshot(0)) == 6
        ev.tile_cache = TileCache(capacity_bytes=0)  # off: exact range
        assert ev._reconstruct_interval(0, 1000, 5 * 8192, None) == got
        ev.close()


# ---------------------------------------------------------------------------
class TestRepairSession:
    def test_consume_coverage_and_gaps(self):
        sess = repair_session.RebuildSession(7, (1,))
        assert sess.donate(1, 0, b"a" * 100)
        assert sess.donate(1, 300, b"b" * 100)
        covered, gaps = sess.consume(0, 500)
        assert [(off, per[1]) for off, per in covered] == [
            (0, b"a" * 100),
            (300, b"b" * 100),
        ]
        assert gaps == [(100, 200), (400, 100)]

    def test_donation_clipped_to_tile_keeps_remainder(self):
        sess = repair_session.RebuildSession(7, (1,))
        sess.donate(1, 50, b"x" * 100)  # spans [50, 150)
        covered, gaps = sess.consume(0, 100)
        assert [(off, len(per[1])) for off, per in covered] == [(50, 50)]
        assert gaps == [(0, 50)]
        # the out-of-window tail [100, 150) survives for the next tile
        covered2, gaps2 = sess.consume(100, 100)
        assert [(off, per[1]) for off, per in covered2] == [(100, b"x" * 50)]
        assert gaps2 == [(150, 50)]

    def test_donation_overlapping_claim_is_trimmed_not_rejected(self):
        sess = repair_session.RebuildSession(7, (1,))
        sess.consume(0, 100)  # claim [0, 100)
        assert sess.donate(1, 50, b"y" * 100)  # [50,150): head claimed
        covered, gaps = sess.consume(100, 100)
        assert [(off, per[1]) for off, per in covered] == [(100, b"y" * 50)]
        assert gaps == [(150, 50)]

    def test_late_donations_for_claimed_ranges_rejected(self):
        sess = repair_session.RebuildSession(7, (1,))
        sess.consume(0, 1000)
        assert not sess.donate(1, 0, b"x" * 100)
        assert sess.donate(1, 1000, b"y" * 100)

    def test_multi_target_requires_all_targets(self):
        sess = repair_session.RebuildSession(7, (1, 2))
        sess.donate(1, 0, b"a" * 100)  # target 2 missing for [0,100)
        covered, gaps = sess.consume(0, 100)
        assert covered == []
        assert gaps == [(0, 100)]
        sess2 = repair_session.RebuildSession(7, (1, 2))
        sess2.donate(1, 0, b"a" * 100)
        sess2.donate(2, 0, b"b" * 100)
        covered, gaps = sess2.consume(0, 100)
        assert len(covered) == 1 and gaps == []

    def test_non_target_donation_rejected(self):
        sess = repair_session.RebuildSession(7, (1,))
        assert not sess.donate(5, 0, b"x" * 10)

    def test_yield_to_serving_waits_bounded(self):
        sess = repair_session.RebuildSession(7, (1,))
        sess.serving_enter()
        t0 = time.perf_counter()
        sess.yield_to_serving(max_wait_s=0.2)
        waited = time.perf_counter() - t0
        assert 0.15 <= waited < 2.0
        assert sess.yields > 0
        sess.serving_exit()
        t0 = time.perf_counter()
        sess.yield_to_serving(max_wait_s=0.2)
        assert time.perf_counter() - t0 < 0.1, "idle serving must not block"

    def test_registry_open_find_close(self):
        sess = repair_session.open_session(42, (3,))
        assert repair_session.find(42) is sess
        repair_session.close_session(sess)
        assert repair_session.find(42) is None

    def test_donation_cap_and_metric(self):
        sess = repair_session.RebuildSession(7, (1,))
        m0 = EC_REPAIR_DONATED_BYTES.value()
        cap = repair_session._DONATION_CAP_BYTES
        assert sess.donate(1, 0, bytes(cap - 10))
        assert not sess.donate(1, cap, b"x" * 11)  # over the cap
        assert EC_REPAIR_DONATED_BYTES.value() - m0 == cap - 10

    def test_random_donations_and_claims_match_reference(self):
        """Same donate/consume sequence through the port's and the
        reference's sessions: same acceptances, coverage, gaps and
        counters."""
        rng = random.Random(11)
        port = repair_session.RebuildSession(7, (1, 4))
        ref = ref_session.RebuildSession(7, (1, 4))
        for off in range(0, 64 * 1000, 4000):
            for _ in range(rng.randrange(4)):
                t = rng.choice((1, 4, 5))
                d_off = off + rng.randrange(-3000, 6000)
                data = bytes([rng.randrange(256)]) * rng.randrange(1, 5000)
                assert port.donate(t, max(0, d_off), data) == ref.donate(
                    t, max(0, d_off), data)
            assert port.consume(off, 4000) == ref.consume(off, 4000)
        for attr in ("donated_bytes", "used_donated_bytes", "yields"):
            assert getattr(port, attr) == getattr(ref, attr)

    def test_stream_rebuild_consumes_donations_byte_identical(self, tmp_path):
        d = str(tmp_path)
        base = os.path.join(d, "7")
        rng = random.Random(3)
        with open(base + ".dat", "wb") as f:
            f.write(bytes(rng.randbytes(3_000_000)))
        rs = new_encoder(backend="cpu")
        ec_files.write_ec_files(base, rs=rs)
        shard_bytes = {}
        for i in range(14):
            with open(base + ec_files.to_ext(i), "rb") as f:
                shard_bytes[i] = f.read()
        os.remove(base + ec_files.to_ext(1))
        remote = {}
        for i in (10, 11, 12, 13):
            os.remove(base + ec_files.to_ext(i))
            remote[i] = (
                lambda off, size, data=shard_bytes[i]: data[off : off + size]
            )
        rl0 = EC_REPAIR_BYTES_READ.value("local")
        rr0 = EC_REPAIR_BYTES_READ.value("remote")
        w0 = EC_REPAIR_BYTES_WRITTEN.value()
        sess = repair_session.open_session(7, (1,))
        for off in (0, 262144):  # 512 KiB of 1 MiB donated
            sess.donate(1, off, shard_bytes[1][off : off + 262144])
        rfn, ffn = ec_stream.local_rebuild_fns(rs)
        stats: dict = {}
        rebuilt = ec_stream.stream_rebuild_ec_files(
            base,
            rebuild_fn=rfn,
            fetch_fn=ffn,
            remote_readers=remote,
            session=sess,
            durable=True,
            stats=stats,
        )
        repair_session.close_session(sess)
        assert rebuilt == [1]
        with open(base + ec_files.to_ext(1), "rb") as f:
            assert f.read() == shard_bytes[1], "donated rebuild differs"
        shard_len = len(shard_bytes[1])
        read = (
            EC_REPAIR_BYTES_READ.value("local")
            - rl0
            + EC_REPAIR_BYTES_READ.value("remote")
            - rr0
        )
        written = EC_REPAIR_BYTES_WRITTEN.value() - w0
        assert written == shard_len
        # donations halve the gather: 10 survivors x the uncovered half
        assert read == 10 * (shard_len - 524288)
        assert stats["used_donated_bytes"] == 524288

    @pytest.mark.parametrize("want_crcs", [False, True])
    def test_stream_rebuild_on_the_cuda_stage_consumes_donations(self, tmp_path, want_crcs):
        """The same donation rebuild through the default stage pair
        (K1 + K4's plain versions on device="cpu"), four targets, CRCs
        folded across donated and decoded ranges."""
        from seaweedfs_tpu_torch.util.crc import crc32c

        d = str(tmp_path)
        base = os.path.join(d, "7")
        with open(base + ".dat", "wb") as f:
            f.write(random.Random(4).randbytes(2_500_000))
        ec_files.write_ec_files(base, rs=new_encoder(backend="cpu"))
        lost = (0, 5, 10, 13)
        shard = {}
        for i in lost:
            with open(base + ec_files.to_ext(i), "rb") as f:
                shard[i] = f.read()
            os.remove(base + ec_files.to_ext(i))
        sess = repair_session.open_session(7, lost)
        for off in (262144, 786432):
            for i in lost:
                assert sess.donate(i, off, shard[i][off : off + 262144])
        rl0 = EC_REPAIR_BYTES_READ.value("local")
        stats: dict = {}
        try:
            got = ec_stream.stream_rebuild_ec_files(
                base, tile_bytes=262144, session=sess, want_crcs=want_crcs,
                stats=stats, device="cpu")
        finally:
            repair_session.close_session(sess)
        assert got == list(lost)
        shard_len = len(shard[0])
        for i in lost:
            with open(base + ec_files.to_ext(i), "rb") as f:
                assert f.read() == shard[i]
        assert stats["used_donated_bytes"] == 2 * 262144 * 4
        assert EC_REPAIR_BYTES_READ.value("local") - rl0 == 10 * (shard_len - 2 * 262144)
        if want_crcs:
            assert stats["shard_crcs"] == {i: crc32c(shard[i]) for i in lost}
            assert stats["host_crc_rows"] == 2 * 4  # the donated tiles

    def test_donate_cached_tiles_seeds_session(self, tmp_path):
        ev, payload = _local_ec_volume(tmp_path, vid=9)
        ev.quarantine_shard(0, "test")
        for k in payload:
            ev.read_needle(k)  # warms the tile cache
        assert ev.tile_cache.total_bytes > 0
        sess = repair_session.RebuildSession(9, (0,))
        donated = ev.donate_cached_tiles(sess)
        assert donated > 0
        assert sess.donated_bytes == ev.tile_cache.total_bytes
        ev.close()

    def test_degraded_reads_donate_to_an_open_session(self, tmp_path):
        """Tiles decoded while a session is open are donated as they
        land, and the serving counter is balanced afterwards."""
        ev, payload = _local_ec_volume(tmp_path, vid=9)
        ev.quarantine_shard(0, "test")
        sess = repair_session.open_session(9, (0,))
        try:
            for k in payload:
                ev.read_needle(k)
            assert sess.donated_bytes == ev.tile_cache.total_bytes > 0
            assert sess._serving == 0
            covered, gaps = sess.consume(0, ev.tile_cache.tile_bytes)
            assert covered and covered[0][0] == 0
        finally:
            repair_session.close_session(sess)
        ev.close()

    def test_chip_smoke_degraded_phase_on_the_cpu(self, tmp_path):
        """chip_smoke.py's degraded phase at a small size with K1's
        plain version: every needle read with 4 shards lost, the warm
        pass, the singleflight under 8 threads, the piggybacked rebuild
        (donations used, survivor reads cut by them) and the parity
        rebuild, byte-identical with the encode's CRCs."""
        import chip_smoke

        d = str(tmp_path)
        base = os.path.join(d, "1")
        _, entries = write_volume(base, 24 << 20, 3)
        st: dict = {}
        ec_files.write_ec_files(base, rs=new_encoder(backend="cpu"), want_crcs=True, stats=st)
        ec_files.write_sorted_file_from_idx(base)
        originals = os.path.join(d, "orig")
        os.mkdir(originals)
        for i in range(14):
            shutil.copyfile(base + ec_files.to_ext(i),
                            os.path.join(originals, "1" + ec_files.to_ext(i)))
        runs = chip_smoke.run_degraded_phase(d, entries, originals, st["shard_crcs"],
                                             device="cpu", card="cpu")
        cold = runs["degraded"]["cold"]
        assert cold["needles"] == len(entries) and cold["degraded_needles"] > 0
        assert cold["apply_calls"] > 0 and cold["tile_misses"] > 0
        assert runs["degraded"]["warm"]["resident"] > 0
        pig = runs["repair_piggyback"]
        assert pig["stats"]["used_donated_bytes"] > 0
        shard_len = os.path.getsize(base + ".ec00")
        assert pig["read_bytes"] == 10 * (shard_len - pig["stats"]["used_donated_bytes"] // 2)
        assert sorted(runs["repair_parity"]["stats"]["shard_crcs"]) == [10, 13]


# ---------------------------------------------------------------------------
# live mini-cluster, one per package: degraded serving + piggybacked
# rebuild end to end (tests/test_ec_degraded.py's TestDegradedServingEndToEnd)
@pytest.fixture(scope="module", params=("ref", "port"))
def degraded_cluster(request, tmp_path_factory):
    from seaweedfs_tpu.server.master_server import MasterServer as RefMaster
    from seaweedfs_tpu.server.volume_server import VolumeServer as RefVolume
    from seaweedfs_tpu_torch.server.master_server import MasterServer as PortMaster
    from seaweedfs_tpu_torch.server.volume_server import VolumeServer as PortVolume
    from seaweedfs_tpu_torch.util.availability import free_port

    side = request.param
    Master, Volume = (RefMaster, RefVolume) if side == "ref" else (PortMaster, PortVolume)
    codec = dict(ec_codec="cpu") if side == "ref" else dict(ec_codec="cuda", device="cpu")
    master = Master(port=free_port(), volume_size_limit_mb=64, vacuum_interval=0,
                    repair_interval=0)
    master.start()
    servers = []
    for i in range(3):
        vs = Volume([str(tmp_path_factory.mktemp(f"{side}-deg{i}"))], port=free_port(),
                    master=f"127.0.0.1:{master.port}", rack=f"rack{i}",
                    heartbeat_interval=0.2, max_volume_counts=[100], scrub_interval=0,
                    **codec)
        vs.start()
        servers.append(vs)
    deadline = time.time() + 45
    while time.time() < deadline and len(master.topology.data_nodes()) != 3:
        time.sleep(0.1)
    assert len(master.topology.data_nodes()) == 3
    yield side, master, servers
    for vs in servers:
        vs.stop()
    master.stop()


class TestDegradedServingEndToEnd:
    """A shard killed over the operator route on a live cluster: degraded
    GETs from a surviving holder are byte-identical, the second pass is
    all tile-cache hits, and a rebuild on the warm node takes the cached
    tiles as donated ranges. The same seeded writes on each package's own
    cluster; the port's decodes run K1's plain version."""

    def _seed_and_encode(self, side, master, n=24):
        import io
        import json
        import urllib.request

        if side == "ref":
            from seaweedfs_tpu.shell.command_env import CommandEnv
            from seaweedfs_tpu.shell.commands import do_ec_encode
        else:
            from seaweedfs_tpu_torch.shell.command_env import CommandEnv
            from seaweedfs_tpu_torch.shell.commands import do_ec_encode
        rng = random.Random(11)
        keys = {}
        vid = None
        for i in range(n):
            with urllib.request.urlopen(
                    f"http://127.0.0.1:{master.port}/dir/assign", timeout=10) as r:
                a = json.loads(r.read())
            data = bytes(rng.randbytes(1800 + i))
            urllib.request.urlopen(urllib.request.Request(
                f"http://{a['url']}/{a['fid']}", data=data, method="POST",
                headers={"Content-Type": "application/octet-stream"}), timeout=10).close()
            keys[a["fid"]] = data
            vid = int(a["fid"].partition(",")[0])
        do_ec_encode(CommandEnv([f"127.0.0.1:{master.port}"]), vid, "", io.StringIO())
        return vid, keys

    def test_degraded_get_tile_cache_and_piggybacked_rebuild(self, degraded_cluster):
        import urllib.request

        import seaweedfs_tpu.stats.metrics as ref_metrics
        import seaweedfs_tpu_torch.stats.metrics as port_metrics
        from seaweedfs_tpu_torch.pb import rpc, volume_pb2
        from tests.faults import DeadShard

        side, master, servers = degraded_cluster
        metrics = ref_metrics if side == "ref" else port_metrics
        vid, keys = self._seed_and_encode(side, master)
        holder = next(vs for vs in servers if (ev := vs.store.find_ec_volume(vid)) is not None
                      and 0 in ev.shards)
        assert DeadShard(vid, sid=0, addr=f"127.0.0.1:{holder.port}").kill() == 0
        server = next(vs for vs in servers if vs.store.find_ec_volume(vid) is not None
                      and vs.store.find_ec_volume(vid).shard_ids())
        d0 = metrics.EC_DEGRADED_READS.value()

        def get_all():
            for fid, data in keys.items():
                with urllib.request.urlopen(f"http://127.0.0.1:{server.port}/{fid}",
                                            timeout=30) as r:
                    assert r.read() == data, f"degraded GET {fid} corrupt"

        def tiles():
            return metrics.EC_TILE_CACHE.value("hit"), metrics.EC_TILE_CACHE.value("miss")

        get_all()
        assert metrics.EC_DEGRADED_READS.value() > d0
        h1, m1 = tiles()
        get_all()
        h2, m2 = tiles()
        assert m2 == m1 and h2 > h1, "warm pass must be all cache hits"
        don0 = metrics.EC_REPAIR_DONATED_BYTES.value()
        with rpc.dial(f"127.0.0.1:{server.port + 10000}") as ch:
            resp = rpc.volume_stub(ch).VolumeEcShardsRebuild(
                volume_pb2.VolumeEcShardsRebuildRequest(volume_id=vid), timeout=120)
        assert list(resp.rebuilt_shard_ids) == [0]
        assert metrics.EC_REPAIR_DONATED_BYTES.value() > don0, \
            "piggyback: cached degraded tiles never reached the rebuild"
        server.store.mount_ec_shards(vid, "", [0])
        for fid, data in list(keys.items())[:5]:
            with urllib.request.urlopen(f"http://127.0.0.1:{server.port}/{fid}",
                                        timeout=30) as r:
                assert r.read() == data
