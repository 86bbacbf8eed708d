"""The port's volume store against seaweedfs_tpu's, on the CPU: needle
maps, Volume (write, group commit, delete, read, vacuum with its
catch-up diff, tail repair, tiering), DiskLocation and Store.

The classes follow tests/test_storage_engine.py (TestCompactNeedleMap,
TestVolume, TestVacuum, TestStore, TestConcurrentVacuum,
TestNeedleMapBulk, TestTtlExpiry, TestFaultInjection), but each test
runs the same seeded operations through both packages, each in its own
directory, with the volumes' clock pinned (`_now_ns`) in both. The
tolerance is byte identity: the same .dat and .idx bytes, the same
reads, the same errors (by class name) and the same metrics.
"""

import os
import random
import threading
import time
import types

import pytest

import seaweedfs_tpu.storage.backend as ref_backend
import seaweedfs_tpu.storage.backend_dir as ref_backend_dir
import seaweedfs_tpu.storage.disk_location as ref_disk_location
import seaweedfs_tpu.storage.file_id as ref_file_id
import seaweedfs_tpu.storage.needle as ref_needle
import seaweedfs_tpu.storage.needle_map as ref_needle_map
import seaweedfs_tpu.storage.store as ref_store
import seaweedfs_tpu.storage.ttl as ref_ttl
import seaweedfs_tpu.storage.volume as ref_volume
import seaweedfs_tpu.storage.volume_info as ref_volume_info
import seaweedfs_tpu_torch.storage.backend as port_backend
import seaweedfs_tpu_torch.storage.backend_dir as port_backend_dir
import seaweedfs_tpu_torch.storage.disk_location as port_disk_location
import seaweedfs_tpu_torch.storage.file_id as port_file_id
import seaweedfs_tpu_torch.storage.needle as port_needle
import seaweedfs_tpu_torch.storage.needle_map as port_needle_map
import seaweedfs_tpu_torch.storage.store as port_store
import seaweedfs_tpu_torch.storage.ttl as port_ttl
import seaweedfs_tpu_torch.storage.volume as port_volume
import seaweedfs_tpu_torch.storage.volume_info as port_volume_info
from seaweedfs_tpu_torch.stats.metrics import COMMIT_FLUSHES
from seaweedfs_tpu_torch.storage import types as t


def _pkg(volume, needle, needle_map, store, disk_location, ttl, backend, backend_dir,
         volume_info, file_id):
    return types.SimpleNamespace(
        Volume=volume.Volume, volume=volume, Needle=needle.Needle,
        CompactNeedleMap=needle_map.CompactNeedleMap, DbNeedleMap=needle_map.DbNeedleMap,
        Store=store.Store, DiskLocation=disk_location.DiskLocation,
        disk_location=disk_location, TTL=ttl.TTL, backend=backend,
        backend_dir=backend_dir, volume_info=volume_info, file_id=file_id,
        scan_volume_file=volume.scan_volume_file,
    )


REF = _pkg(ref_volume, ref_needle, ref_needle_map, ref_store, ref_disk_location, ref_ttl,
           ref_backend, ref_backend_dir, ref_volume_info, ref_file_id)
PORT = _pkg(port_volume, port_needle, port_needle_map, port_store, port_disk_location,
            port_ttl, port_backend, port_backend_dir, port_volume_info, port_file_id)
CLOCK0 = 1_700_000_000_000_000_000


def _pinned_now(self) -> int:
    """A deterministic _now_ns: strictly increasing, as the real one."""
    return (self.last_append_at_ns or CLOCK0) + 1000


@pytest.fixture(autouse=True)
def pinned_clock(monkeypatch):
    for pkg in (REF, PORT):
        monkeypatch.setattr(pkg.Volume, "_now_ns", _pinned_now)


def outcome(fn, *args, **kwargs):
    """("ok", value) or (exception class name,): errors compared across
    the packages by name."""
    try:
        return ("ok", fn(*args, **kwargs))
    except Exception as e:  # noqa: BLE001 - the class is the observable
        return (type(e).__name__,)


def both(tmp_path, fn):
    """fn(pkg, directory) on the reference and on the port, each in its
    own directory; returns (ref result, port result, ref dir, port dir)."""
    dirs = []
    results = []
    for name, pkg in (("ref", REF), ("port", PORT)):
        d = str(tmp_path / name)
        os.makedirs(d, exist_ok=True)
        dirs.append(d)
        results.append(fn(pkg, d))
    return results[0], results[1], dirs[0], dirs[1]


def assert_same_files(a: str, b: str, exts=(".dat", ".idx")) -> None:
    """The same files with these extensions, byte for byte."""
    names = sorted(n for n in os.listdir(a) if n.endswith(exts))
    assert names == sorted(n for n in os.listdir(b) if n.endswith(exts))
    assert names, "nothing to compare"
    for n in names:
        with open(os.path.join(a, n), "rb") as fa, open(os.path.join(b, n), "rb") as fb:
            assert fa.read() == fb.read(), n


def needle(pkg, nid, data=None, cookie=0x12345678):
    return pkg.Needle(cookie=cookie, id=nid,
                      data=data if data is not None else f"data-{nid}".encode())


def read(v, nid, cookie=None):
    return outcome(lambda: bytes(v.read_needle(nid, cookie).data))


def stats(v) -> dict:
    s = v.stats_snapshot()
    s.update(max_file_key=v.max_file_key(), content=v.content_size(),
             last_ns=v.last_append_at_ns)
    return s


# --- needle maps ----------------------------------------------------------------


def _map(pkg, kind, path):
    return (pkg.DbNeedleMap if kind == "db" else pkg.CompactNeedleMap).load(path)


def _map_state(m, keys):
    got = {k: (lambda nv: None if nv is None else (nv.offset, nv.size))(m.get(k))
           for k in keys}
    return got, (m.file_count, m.file_byte_count, m.deletion_count,
                 m.deletion_byte_count, m.max_file_key, len(m))


@pytest.mark.parametrize("kind", ["memory", "db"])
class TestCompactNeedleMap:
    def test_put_get_delete(self, tmp_path, kind):
        def run(pkg, d):
            nm = _map(pkg, kind, os.path.join(d, "v.idx"))
            nm.put(5, 100, 50)
            nm.put(9, 200, 60)
            freed = nm.delete(5, 300)
            out = (freed, nm.content_size(), nm.deleted_size(), _map_state(nm, (5, 9, 404)))
            nm.close()
            return out

        r, p, a, b = both(tmp_path, run)
        assert r == p and p[0] == 50
        assert_same_files(a, b, (".idx",))

    def test_persistence_roundtrip(self, tmp_path, kind):
        def run(pkg, d):
            path = os.path.join(d, "v.idx")
            nm = _map(pkg, kind, path)
            for k in range(1, 100):
                nm.put(k, k * 10, k)
            nm.delete(50, 9999)
            nm.close()
            nm2 = _map(pkg, kind, path)
            out = _map_state(nm2, range(0, 102))
            visited = []
            nm2.ascending_visit(lambda nv: visited.append((nv.key, nv.offset, nv.size)))
            nm2.close()
            return out, visited

        r, p, a, b = both(tmp_path, run)
        assert r == p and p[0][0][50] == (500, t.TOMBSTONE_FILE_SIZE)
        assert_same_files(a, b, (".idx",))

    def test_overwrite_counts_old_as_deleted(self, tmp_path, kind):
        def run(pkg, d):
            nm = _map(pkg, kind, os.path.join(d, "v.idx"))
            nm.put(1, 10, 100)
            nm.put(1, 20, 120)
            out = (nm.deletion_byte_count, _map_state(nm, (1,)))
            nm.close()
            return out

        r, p, _, _ = both(tmp_path, run)
        assert r == p and p[0] == 100


# --- Volume ---------------------------------------------------------------------


class TestVolume:
    def test_write_read_roundtrip(self, tmp_path):
        def run(pkg, d):
            v = pkg.Volume(d, 1)
            w = v.write_needle(needle(pkg, 42, b"hello volume"))
            out = (w, read(v, 42), read(v, 42, 0x12345678), stats(v))
            v.close()
            return out

        r, p, a, b = both(tmp_path, run)
        assert r == p and p[1] == ("ok", b"hello volume")
        assert_same_files(a, b)

    def test_duplicate_write_unchanged(self, tmp_path):
        def run(pkg, d):
            v = pkg.Volume(d, 1)
            out = [v.write_needle(needle(pkg, 1, b"same")),
                   v.write_needle(needle(pkg, 1, b"same")),
                   v.write_needle(needle(pkg, 1, b"different")), stats(v)]
            v.close()
            return out

        r, p, a, b = both(tmp_path, run)
        assert r == p and p[1][2] and not p[2][2]
        assert_same_files(a, b)

    def test_cookie_checks(self, tmp_path):
        def run(pkg, d):
            v = pkg.Volume(d, 1)
            v.write_needle(needle(pkg, 1, b"x", cookie=0xAAAA))
            out = (outcome(v.write_needle, needle(pkg, 1, b"y", cookie=0xBBBB)),
                   read(v, 1, 0xBBBB), read(v, 1, 0xAAAA))
            v.close()
            return out

        r, p, a, b = both(tmp_path, run)
        assert r == p == (("CookieMismatch",), ("CookieMismatch",), ("ok", b"x"))
        assert_same_files(a, b)

    def test_delete(self, tmp_path):
        def run(pkg, d):
            v = pkg.Volume(d, 1)
            v.write_needle(needle(pkg, 7, b"doomed"))
            out = (v.delete_needle(needle(pkg, 7)), read(v, 7),
                   v.delete_needle(needle(pkg, 7)), stats(v))
            v.close()
            return out

        r, p, a, b = both(tmp_path, run)
        assert r == p and p[0] > 0 and p[1] == ("NeedleNotFound",) and p[2] == 0
        assert_same_files(a, b)

    def test_reload_preserves_state(self, tmp_path):
        def run(pkg, d):
            v = pkg.Volume(d, 3, collection="col")
            for k in range(1, 20):
                v.write_needle(needle(pkg, k))
            v.delete_needle(needle(pkg, 5))
            v.close()
            v2 = pkg.Volume(d, 3, collection="col", create=False)
            out = (read(v2, 10), read(v2, 5), stats(v2))
            v2.close()
            return out

        r, p, a, b = both(tmp_path, run)
        assert r == p and p[0] == ("ok", b"data-10") and p[2]["file_count"] == 19
        assert_same_files(a, b)

    def test_append_at_ns_monotonic(self, tmp_path):
        def run(pkg, d):
            v = pkg.Volume(d, 1)
            stamps = []
            for k in range(1, 10):
                v.write_needle(needle(pkg, k))
                stamps.append(v.last_append_at_ns)
            v.close()
            return stamps

        r, p, a, b = both(tmp_path, run)
        assert r == p == sorted(set(p))
        assert_same_files(a, b)

    def test_readonly_blocks_writes(self, tmp_path):
        def run(pkg, d):
            v = pkg.Volume(d, 1)
            v.read_only = True
            out = (outcome(v.write_needle, needle(pkg, 1)),
                   outcome(v.delete_needle, needle(pkg, 1)),
                   outcome(v.write_needles, [(needle(pkg, 2), None)]))
            v.close()
            return out

        r, p, _, _ = both(tmp_path, run)
        assert r == p == (("VolumeReadOnly",),) * 3

    def test_corrupt_tail_detected_on_load(self, tmp_path):
        def run(pkg, d):
            v = pkg.Volume(d, 1)
            v.write_needle(needle(pkg, 1, b"will truncate"))
            v.close()
            dat = os.path.join(d, "1.dat")
            os.truncate(dat, os.path.getsize(dat) - 8)
            return outcome(pkg.Volume, d, 1, create=False)

        r, p, _, _ = both(tmp_path, run)
        assert r == p == ("CorruptNeedle",)

    @pytest.mark.parametrize("seed", [0, 1, 2])
    def test_random_operations_match(self, tmp_path, seed):
        """Seeded writes (TTL'd, named, overwritten), deletes, group
        commits and reads: the same files, reads, errors and metrics."""

        def run(pkg, d):
            rng = random.Random(seed)
            v = pkg.Volume(d, 4, collection="c", replica_placement=None)
            log = []
            cookies = {}
            for step in range(300):
                op = rng.random()
                nid = rng.randint(1, 80)
                if op < 0.45:
                    n = needle(pkg, nid, rng.randbytes(rng.randint(0, 3000)),
                               cookie=cookies.setdefault(nid, rng.getrandbits(32)))
                    if rng.random() < 0.2:
                        n.name = b"file-%d.bin" % nid
                        n.set_has_name()
                    if rng.random() < 0.1:
                        n.cookie ^= 1  # a wrong cookie for an existing id
                    log.append(outcome(v.write_needle, n))
                elif op < 0.6:
                    batch = [(needle(pkg, rng.randint(1, 80),
                                     rng.randbytes(rng.randint(1, 500)),
                                     cookie=cookies.setdefault(nid, rng.getrandbits(32))),
                              None) for _ in range(rng.randint(1, 6))]
                    res = v.write_needles(batch, durable=rng.random() < 0.5)
                    log.append([x if isinstance(x, tuple) else type(x).__name__
                                for x in res])
                elif op < 0.75:
                    log.append(outcome(v.delete_needle, needle(pkg, nid)))
                else:
                    log.append(read(v, nid, cookies.get(nid)))
                if step % 97 == 0:
                    log.append(stats(v))
            v.commit()
            log.append(stats(v))
            log.append([(n.id, off, len(n.data), n.append_at_ns)
                        for n, off in pkg.scan_volume_file(os.path.join(d, "c_4.dat"))])
            v.close()
            return log

        flushes = COMMIT_FLUSHES.value()
        r, p, a, b = both(tmp_path, run)
        assert r == p
        assert_same_files(a, b)
        assert COMMIT_FLUSHES.value() > flushes

    def test_group_commit_with_a_duplicate(self, tmp_path):
        """write_needles with an id twice in one batch: the second is
        deferred to a serial write after the batch, in both packages."""

        def run(pkg, d):
            v = pkg.Volume(d, 5)
            batch = [(needle(pkg, k, b"x" * k), None) for k in (1, 2, 3, 2, 4)]
            res = v.write_needles(batch)
            v.close()
            return res

        r, p, a, b = both(tmp_path, run)
        # the duplicate equals its batchmate: the deferred write is a no-op
        assert r == p and [x[2] for x in p] == [False, False, False, True, False]
        assert_same_files(a, b)

    def test_tier_upload_and_download(self, tmp_path):
        """A sealed volume moved to a `dir` backend and back: reads are
        served from the backend while it is remote; the .dat returns
        byte-identical."""

        def run(pkg, d):
            pkg.backend.ensure_builtin_factories()
            pkg.backend.load_backend_config(
                {"dir": {"tier": {"enabled": True, "dir": os.path.join(d, "remote")}}})
            v = pkg.Volume(d, 6)
            for k in range(1, 30):
                v.write_needle(needle(pkg, k, bytes([k]) * (k * 37)))
            v.delete_needle(needle(pkg, 3))
            with open(os.path.join(d, "6.dat"), "rb") as f:
                before = f.read()
            key, size = v.tier_upload("dir.tier")
            remote = (os.path.exists(os.path.join(d, "6.dat")), v.read_only,
                      read(v, 10), read(v, 3), outcome(v.write_needle, needle(pkg, 99)))
            v.close()
            v2 = pkg.Volume(d, 6, create=False)  # reloads through the .vif
            reloaded = (v2.read_only, read(v2, 20), v2.has_remote_file())
            got = v2.tier_download()
            with open(os.path.join(d, "6.dat"), "rb") as f:
                after = f.read()
            back = (got == size, after == before, v2.read_only,
                    os.path.exists(os.path.join(d, "6.vif")), read(v2, 29))
            v2.close()
            return remote, reloaded, back

        try:
            r, p, a, b = both(tmp_path, run)
        finally:
            REF.backend.BACKEND_STORAGES.pop("dir.tier", None)
            PORT.backend.BACKEND_STORAGES.pop("dir.tier", None)
        assert r == p
        assert p[0][:2] == (False, True) and p[0][4] == ("VolumeReadOnly",)
        assert p[2] == (True, True, False, False, ("ok", bytes([29]) * (29 * 37)))
        assert_same_files(a, b)

    def test_unconfigured_backend_raises(self, tmp_path):
        def run(pkg, d):
            pkg.backend.ensure_builtin_factories()
            v = pkg.Volume(d, 7)
            out = outcome(v.tier_upload, "s3.nowhere")
            v.close()
            return out

        r, p, _, _ = both(tmp_path, run)
        assert r == p == ("RuntimeError",)
        with pytest.raises(ValueError):  # the port registers `dir` only
            PORT.backend.load_backend_config({"s3": {"default": {"enabled": True}}})
        assert PORT.backend.get_backend("s3.default") is None

    def test_refresh_from_idx_follows_another_writer(self, tmp_path):
        def run(pkg, d):
            owner = pkg.Volume(d, 8)
            owner.write_needle(needle(pkg, 1))
            follower = pkg.Volume(d, 8, create=False)
            for k in range(2, 6):
                owner.write_needle(needle(pkg, k))
            before = read(follower, 4)
            follower.refresh_from_idx()
            out = (before, read(follower, 4), follower.file_count())
            owner.close()
            follower.close()
            return out

        r, p, a, b = both(tmp_path, run)
        assert r == p and p[0] == ("NeedleNotFound",) and p[1] == ("ok", b"data-4")
        assert_same_files(a, b)


# --- vacuum -----------------------------------------------------------------------


class TestVacuum:
    def test_compact_reclaims_deleted(self, tmp_path):
        def run(pkg, d):
            v = pkg.Volume(d, 2)
            rng = random.Random(0)
            for k in range(1, 101):
                v.write_needle(needle(pkg, k, rng.randbytes(rng.randint(10, 500))))
            for k in rng.sample(range(1, 101), 30):
                v.delete_needle(needle(pkg, k))
            before = (v.data_file_size(), v.garbage_level())
            v.compact()
            v.commit_compact()
            out = (before, v.data_file_size(), v.super_block.compaction_revision,
                   [read(v, k) for k in range(1, 101)], stats(v))
            v.close()
            return out

        r, p, a, b = both(tmp_path, run)
        assert r == p and p[1] < p[0][0] and p[2] == 1
        assert_same_files(a, b)

    def test_compact_then_reload(self, tmp_path):
        def run(pkg, d):
            v = pkg.Volume(d, 2)
            for k in range(1, 11):
                v.write_needle(needle(pkg, k))
            v.delete_needle(needle(pkg, 3))
            v.compact()
            v.commit_compact()
            v.close()
            v2 = pkg.Volume(d, 2, create=False)
            out = (v2.file_count(), read(v2, 10), read(v2, 3))
            v2.close()
            return out

        r, p, a, b = both(tmp_path, run)
        assert r == p and p[0] == 9
        assert_same_files(a, b)

    def test_cleanup_removes_scratch(self, tmp_path):
        def run(pkg, d):
            v = pkg.Volume(d, 2)
            v.write_needle(needle(pkg, 1))
            v.compact()
            made = sorted(os.listdir(d))
            v.cleanup_compact()
            out = (made, sorted(os.listdir(d)), outcome(v.commit_compact))
            v.close()
            return out

        r, p, _, _ = both(tmp_path, run)
        assert r == p and "2.cpd" in p[0] and "2.cpd" not in p[1]
        assert p[2] == ("FileNotFoundError",)

    def test_commit_marker_rolls_forward_on_repair(self, tmp_path):
        """A crash after the .cpm commit point: the repairing load rolls
        the swap forward, in both packages to the same bytes."""

        def run(pkg, d):
            v = pkg.Volume(d, 2)
            for k in range(1, 21):
                v.write_needle(needle(pkg, k))
            for k in (2, 4, 6):
                v.delete_needle(needle(pkg, k))
            v.compact()
            v._makeup_diff(os.path.join(d, "2.cpd"), os.path.join(d, "2.cpx"))
            with open(os.path.join(d, "2.cpm"), "wb") as f:
                f.write(b"commit\n")
            v.close()
            v2 = pkg.Volume(d, 2, create=False, repair=True)
            out = (sorted(os.listdir(d)), v2.super_block.compaction_revision,
                   [read(v2, k) for k in range(1, 21)])
            v2.close()
            return out

        r, p, a, b = both(tmp_path, run)
        assert r == p and p[1] == 1 and "2.cpm" not in p[0]
        assert_same_files(a, b)


class TestConcurrentVacuum:
    def test_writes_during_compaction_survive_commit(self, tmp_path):
        def run(pkg, d):
            v = pkg.Volume(d, 11)
            for i in range(1, 6):
                v.write_needle(pkg.Needle(cookie=i, id=i, data=f"pre {i}".encode() * 50))
            v.delete_needle(pkg.Needle(cookie=2, id=2))
            v.compact()
            v.write_needle(pkg.Needle(cookie=100, id=100, data=b"mid-compaction write"))
            v.write_needle(pkg.Needle(cookie=3, id=3, data=b"overwritten!"))
            v.delete_needle(pkg.Needle(cookie=4, id=4))
            v.commit_compact()
            v.cleanup_compact()
            live = [read(v, k, c) for k, c in ((100, 100), (3, 3), (1, 1), (2, None),
                                               (4, None))]
            v.close()
            v2 = pkg.Volume(d, 11, create=False)
            again = [read(v2, k, c) for k, c in ((100, 100), (3, 3), (4, None))]
            v2.close()
            return live, again

        r, p, a, b = both(tmp_path, run)
        assert r == p
        assert p[0][:3] == [("ok", b"mid-compaction write"), ("ok", b"overwritten!"),
                            ("ok", b"pre 1" * 50)]
        assert p[0][3:] == [("NeedleNotFound",)] * 2
        assert_same_files(a, b)

    def test_compact_does_not_block_writes(self, tmp_path, monkeypatch):
        """The copy runs without the volume lock: a write lands while it
        runs, and the committed files equal the reference's after the
        same interleaving (the write is replayed by the diff)."""

        def run(pkg, d):
            v = pkg.Volume(d, 12)
            for i in range(1, 200):
                v.write_needle(pkg.Needle(cookie=i, id=i, data=b"z" * 2000))
            orig = pkg.volume.get_actual_size
            started, release = threading.Event(), threading.Event()

            def gated_size(size, version):
                if not started.is_set():
                    started.set()
                    assert release.wait(5)
                return orig(size, version)

            monkeypatch.setattr(pkg.volume, "get_actual_size", gated_size)
            th = threading.Thread(target=v.compact)
            th.start()
            assert started.wait(5)
            # the copy is parked inside compact(): the write must not block
            done = threading.Event()

            def writer():
                v.write_needle(pkg.Needle(cookie=999, id=999, data=b"concurrent write"))
                done.set()

            w = threading.Thread(target=writer)
            w.start()
            ok = done.wait(5)
            release.set()
            th.join()
            w.join()
            monkeypatch.setattr(pkg.volume, "get_actual_size", orig)
            v.commit_compact()
            v.cleanup_compact()
            out = (ok, read(v, 999, 999))
            v.close()
            return out

        r, p, a, b = both(tmp_path, run)
        assert r == p == (True, ("ok", b"concurrent write"))
        assert_same_files(a, b)


# --- store --------------------------------------------------------------------------


class TestStore:
    def test_add_write_read_delete(self, tmp_path):
        def run(pkg, d):
            store = pkg.Store([os.path.join(d, "d1"), os.path.join(d, "d2")])
            store.add_volume(1)
            store.add_volume(2, collection="pics", replica_placement="001")
            w = store.write_needle(1, needle(pkg, 5, b"five"))
            out = [w, outcome(lambda: bytes(store.read_needle(1, 5).data)),
                   store.delete_needle(1, needle(pkg, 5)),
                   outcome(store.read_needle, 1, 5), store.has_volume(2),
                   outcome(store.add_volume, 2), store.delete_volume(2),
                   store.has_volume(2), outcome(store.write_needle, 9, needle(pkg, 1)),
                   store.mark_volume_readonly(1),
                   outcome(store.write_needle, 1, needle(pkg, 6))]
            store.close()
            return out

        r, p, a, b = both(tmp_path, run)
        assert r == p and p[1] == ("ok", b"five") and p[3] == ("NeedleNotFound",)
        assert p[-1] == ("VolumeReadOnly",)
        assert_same_files(os.path.join(a, "d1"), os.path.join(b, "d1"))

    def test_reload_scans_directories(self, tmp_path):
        def run(pkg, d):
            store = pkg.Store([d])
            store.add_volume(7, collection="c")
            store.write_needle(7, needle(pkg, 1, b"persisted"))
            store.close()
            store2 = pkg.Store([d])
            out = (outcome(lambda: bytes(store2.read_needle(7, 1).data)),
                   sorted(store2.locations[0].volumes))
            store2.close()
            return out

        r, p, a, b = both(tmp_path, run)
        assert r == p == (("ok", b"persisted"), [7])
        assert_same_files(a, b)

    def test_heartbeat(self, tmp_path):
        def run(pkg, d):
            store = pkg.Store([d])
            store.add_volume(1)
            store.add_volume(3, collection="x", ttl="5m")
            store.write_needle(1, needle(pkg, 99, b"z"))
            hb = store.collect_heartbeat()
            out = (hb.max_file_key, [vars(v) for v in hb.volumes], hb.ec_shards)
            store.close()
            return out

        r, p, _, _ = both(tmp_path, run)
        assert r == p and p[0] == 99 and len(p[1]) == 2

    def test_mount_unmount_and_needle_map_kind(self, tmp_path):
        def run(pkg, d):
            store = pkg.Store([d], needle_map_kind="db")
            store.add_volume(4)
            for k in range(1, 6):
                store.write_needle(4, needle(pkg, k))
            out = [store.unmount_volume(4), outcome(store.read_needle, 4, 1),
                   store.mount_volume(4),
                   outcome(lambda: bytes(store.read_needle(4, 2).data)),
                   store.mount_volume(77)]
            store.close()
            return out

        r, p, a, b = both(tmp_path, run)
        assert r == p and p[3] == ("ok", b"data-2")
        assert_same_files(a, b)


def test_file_names_and_ids():
    for name in ("1.dat", "pics_12.dat", "a_b_3.dat", "x.dat", "4.idx"):
        assert (PORT.disk_location.parse_volume_file_name(name)
                == REF.disk_location.parse_volume_file_name(name))
    for name in ("7.ec03", "c_7.ec13", "7.ec1", "7.ecx"):
        assert (PORT.disk_location.parse_ec_shard_file_name(name)
                == REF.disk_location.parse_ec_shard_file_name(name))
    for fid in ("3,01637037d6", "12,ab00000001deadbeef", "5,1234567890"):
        a, b = PORT.file_id.FileId.parse(fid), REF.file_id.FileId.parse(fid)
        assert (a.volume_id, a.key, a.cookie, str(a)) == (b.volume_id, b.key, b.cookie, str(b))
    for bad in ("3", "x,01637037d6", "3,12345678", "3,0x637037d6zz"):
        assert outcome(PORT.file_id.FileId.parse, bad)[0] == outcome(
            REF.file_id.FileId.parse, bad)[0]
    for path in ("/3,01637037d6.jpg", "/3/01637037d6/my%20photo.jpg", "/3"):
        assert PORT.file_id.parse_url_path(path) == REF.file_id.parse_url_path(path)
    assert (PORT.file_id.parse_path_fid("3", "01637037d6_3")
            .key == REF.file_id.parse_path_fid("3", "01637037d6_3").key)


def test_volume_info_round_trip(tmp_path):
    vi = PORT.volume_info.VolumeInfo(
        files=[PORT.volume_info.RemoteFile("dir", "default", "k1", 0, 1234, 99, ".dat")],
        version=3)
    PORT.volume_info.save_volume_info(str(tmp_path / "p.vif"), vi)
    got, remote = REF.volume_info.maybe_load_volume_info(str(tmp_path / "p.vif"))
    assert remote and got.version == 3 and got.files[0].key == "k1"
    assert got.files[0].backend_name == "dir.default"
    REF.volume_info.save_volume_info(str(tmp_path / "r.vif"), got)
    assert (tmp_path / "p.vif").read_bytes() == (tmp_path / "r.vif").read_bytes()
    assert PORT.volume_info.maybe_load_volume_info(str(tmp_path / "none.vif"))[1] is False


# --- bulk, TTL, faults ------------------------------------------------------------


class TestNeedleMapBulk:
    N = 100_000

    def test_bulk_load_and_replay(self, tmp_path):
        def run(pkg, d):
            idx = os.path.join(d, "bulk.idx")
            nm = pkg.CompactNeedleMap.load(idx)
            rng = random.Random(7)
            keys = list(range(1, self.N + 1))
            for k in keys:
                nm.put(k, k * 2, 100 + (k % 50))
            for k in rng.sample(keys, self.N // 20):
                nm.put(k, k * 3, 999)
            deleted = rng.sample(keys, self.N // 20)
            for k in deleted:
                nm.delete(k, 0)
            nm.close()
            nm2 = pkg.CompactNeedleMap.load(idx)
            probe = rng.sample(keys, 500) + rng.sample(deleted, 50)
            out = _map_state(nm2, probe)
            nm2.close()
            return out

        r, p, a, b = both(tmp_path, run)
        assert r == p and p[1][4] == self.N
        assert_same_files(a, b, (".idx",))


class TestTtlExpiry:
    def test_expired_needle_reads_as_not_found(self, tmp_path, monkeypatch):
        now = time.time()

        def run(pkg, d):
            v = pkg.Volume(d, 21, ttl=pkg.TTL.parse("1m"))
            for nid, ttl in ((1, "1m"), (2, None)):
                n = pkg.Needle(cookie=1, id=nid, data=b"short lived")
                if ttl:
                    n.ttl = pkg.TTL.parse(ttl)
                    n.set_has_ttl()
                n.last_modified = int(now)
                n.set_has_last_modified_date()
                v.write_needle(n)
            fresh = (read(v, 1, 1), read(v, 2, 1))
            monkeypatch.setattr(pkg.volume.time, "time", lambda: now + 120)
            later = (read(v, 1, 1), read(v, 2, 1))
            monkeypatch.undo()
            for q in (REF, PORT):
                monkeypatch.setattr(q.Volume, "_now_ns", _pinned_now)
            v.close()
            return fresh, later

        r, p, a, b = both(tmp_path, run)
        assert r == p
        assert p[0] == (("ok", b"short lived"),) * 2
        # needle 2 inherits the volume's 1m TTL on write: both expire
        assert p[1] == (("NeedleNotFound",),) * 2
        assert_same_files(a, b)


class TestFaultInjection:
    def test_torn_dat_tail_recovers_on_reload(self, tmp_path):
        def run(pkg, d):
            v = pkg.Volume(d, 3)
            for k in range(1, 6):
                v.write_needle(needle(pkg, k, f"payload-{k}".encode()))
            v.close()
            with open(os.path.join(d, "3.dat"), "ab") as f:
                f.write(b"\xde\xad\xbe\xef" * 7)
            v2 = pkg.Volume(d, 3, repair=True)
            out = [read(v2, k) for k in range(1, 6)]
            v2.write_needle(needle(pkg, 99, b"after-recovery"))
            out.append(read(v2, 99))
            v2.close()
            v3 = pkg.Volume(d, 3)
            out.append(read(v3, 99))
            v3.close()
            return out

        r, p, a, b = both(tmp_path, run)
        assert r == p and p[-1] == ("ok", b"after-recovery")
        assert_same_files(a, b)

    def test_lost_idx_entries_are_reindexed(self, tmp_path):
        """The .dat was fsynced but the tail of the .idx was lost: the
        repairing load re-indexes the records from the .dat."""

        def run(pkg, d):
            v = pkg.Volume(d, 5)
            for k in range(1, 11):
                v.write_needle(needle(pkg, k))
            v.delete_needle(needle(pkg, 4))
            v.close()
            idx = os.path.join(d, "5.idx")
            os.truncate(idx, os.path.getsize(idx) - 3 * t.NEEDLE_MAP_ENTRY_SIZE - 5)
            v2 = pkg.Volume(d, 5, repair=True)
            out = ([read(v2, k) for k in range(1, 11)], stats(v2))
            v2.close()
            return out

        r, p, a, b = both(tmp_path, run)
        assert r == p and p[0][3] == ("NeedleNotFound",) and p[0][9] == ("ok", b"data-10")
        assert_same_files(a, b)

    @pytest.mark.parametrize("kind", ["memory", "db"])
    def test_needle_map_random_ops_match_model(self, tmp_path, kind):
        def run(pkg, d):
            rng = random.Random(7)
            path = os.path.join(d, "m.idx")
            m = _map(pkg, kind, path)
            model: dict[int, tuple[int, int]] = {}
            for step in range(800):
                pick, key = rng.random(), rng.randint(1, 120)
                if pick < 0.6:
                    off, size = rng.randint(1, 1 << 20), rng.randint(1, 1 << 16)
                    m.put(key, off, size)
                    model[key] = (off, size)
                elif key in model:
                    m.delete(key, model[key][0])
                    del model[key]
                if step == 400:
                    m.close()
                    m = _map(pkg, kind, path)
            state = _map_state(m, range(1, 130))
            m.close()
            for key in range(1, 130):
                got = state[0][key]
                if key in model:
                    assert got == model[key], key
                else:
                    assert got is None or got[1] == t.TOMBSTONE_FILE_SIZE, key
            return state

        r, p, a, b = both(tmp_path, run)
        assert r == p
        assert_same_files(a, b, (".idx",))


def test_a_store_needs_the_card_unless_asked(tmp_path, monkeypatch):
    """No card, and neither ec_backend="cpu" nor device="cpu": the port's
    Store, DiskLocation and EcVolume raise instead of serving on the
    host."""
    import torch

    from seaweedfs_tpu_torch.ec.ec_volume import EcVolume

    monkeypatch.delenv("WEED_EC_CODEC", raising=False)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA device"):
        PORT.Store([str(tmp_path)])
    with pytest.raises(RuntimeError, match="CUDA device"):
        PORT.DiskLocation(str(tmp_path))
    with pytest.raises(RuntimeError, match="CUDA device"):
        EcVolume(str(tmp_path), 1)
    for kw in ({"ec_backend": "cpu"}, {"device": "cpu"}, {"ec_backend": "native"}):
        PORT.Store([str(tmp_path)], **kw).close()


def test_chip_smoke_store_phase_on_the_cpu(tmp_path):
    """chip_smoke.py's store phase at a small size with K1's plain
    version: the store's write, vacuum and reads, the encode and rebuild
    on the cuda backend against the native host codec (byte-identical),
    serving with four shards lost, and the tiered reload."""
    import chip_smoke

    runs = chip_smoke.run_store_phase(str(tmp_path), 24 << 20, 3, device="cpu", card="cpu")
    assert sorted(runs) == ["store_encode", "store_rebuild4", "store_serve", "store_tier"]
    assert runs["store_encode"]["native_wall_s"] > 0 and runs["store_encode"]["native_apply_ms"] > 0
    assert len(runs["store_encode"]["stats"]["shard_crcs"]) == 14
    assert sorted(runs["store_rebuild4"]["stats"]["shard_crcs"]) == [0, 5, 10, 13]
    assert runs["store_tier"]["needles"] > 0 and runs["store_tier"]["remote_reads"] > 0
