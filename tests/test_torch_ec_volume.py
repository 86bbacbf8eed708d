"""The port's EcVolume against seaweedfs_tpu's, on the CPU.

Volumes are written from a seed with the port's storage code
(storage.synthetic.write_volume) and encoded by the port's write_ec_files on
its numpy backend. The port's EcVolume runs its cuda backend with
device="cpu" (K1's plain version); the reference's runs with backend
"cpu" (numpy) and "tpu" (under JAX_PLATFORMS=cpu: the bit-matmul XLA
program). On the same shard files with the same shards lost, every
needle and random spans must come back byte-identical from all three,
with the tile cache on and off. The rest ports
tests/test_storage_engine.py::TestEcVolume and its truncation tests,
plus the .ecx/.ecj/.ecc helpers the slice brings in.
"""

import os
import random
import shutil

import numpy as np
import pytest

from seaweedfs_tpu.ec import ec_files as ref_files
from seaweedfs_tpu.ec import ecc_sidecar as ref_sidecar
from seaweedfs_tpu.ec.ec_volume import EcVolume as RefEcVolume
from seaweedfs_tpu.storage import idx as ref_idx
from seaweedfs_tpu.storage.needle_map import SortedNeedleMap as RefSortedNeedleMap
from seaweedfs_tpu_torch.ec import ec_files, ec_stream, ecc_sidecar
from seaweedfs_tpu_torch.ec.codec import new_encoder
from seaweedfs_tpu_torch.ec.ec_volume import EcVolume, NotEnoughShards
from seaweedfs_tpu_torch.storage import idx
from seaweedfs_tpu_torch.storage import types as t
from seaweedfs_tpu_torch.storage.needle import CorruptNeedle, get_actual_size
from seaweedfs_tpu_torch.storage.needle_map import SortedNeedleMap
from seaweedfs_tpu_torch.storage.synthetic import write_volume
from seaweedfs_tpu_torch.storage.volume import NeedleNotFound, volume_base_name

LOST = (0, 5, 10, 13)
VID = 1


def _encode(d: str, nbytes: int, seed: int, max_payload: int, deletes=()) -> tuple:
    """Volume VID in `d`: written, tombstones for `deletes` appended to
    its .idx, encoded and indexed. Returns (dat bytes, {id: (off, size)})."""
    base = os.path.join(d, str(VID))
    _, entries = write_volume(base, nbytes, seed, max_payload=max_payload)
    with open(base + ".idx", "ab") as f:
        for nid in deletes:
            f.write(idx.pack_entry(nid, 0, t.TOMBSTONE_FILE_SIZE))
    ec_files.write_ec_files(base, rs=new_encoder(backend="cpu"))
    ec_files.write_sorted_file_from_idx(base)
    with open(base + ".dat", "rb") as f:
        dat = f.read()
    live = {nid: (off, size) for nid, off, size in entries if nid not in deletes}
    return dat, live


def _record(dat: bytes, off: int, size: int) -> bytes:
    return dat[off : off + get_actual_size(size, 3)]


def _port(d: str) -> EcVolume:
    return EcVolume.load(d, VID, backend="cuda", device="cpu")


@pytest.fixture(scope="module")
def six_mib(tmp_path_factory):
    """A ~6 MiB volume (one small row: data on shards 0-5) with shards
    {0, 5, 10, 13} lost, shared read-only by the side-by-side tests."""
    d = str(tmp_path_factory.mktemp("six_mib"))
    dat, live = _encode(d, 6 << 20, 11, 256 << 10)
    for sid in LOST:
        os.remove(os.path.join(d, str(VID)) + ec_files.to_ext(sid))
    return d, dat, live


@pytest.fixture
def small(tmp_path):
    """The reference fixture's shape: ~60 small needles, one deleted
    before the encode (all data in shard 0's first block)."""
    dat, live = _encode(str(tmp_path), 120_000, 1, 3000, deletes=(13,))
    return str(tmp_path), dat, live


# --- side by side with the reference ---------------------------------------


@pytest.mark.parametrize("cache", ["on", "off"])
def test_every_needle_matches_the_reference(six_mib, monkeypatch, cache):
    d, dat, live = six_mib
    if cache == "off":
        monkeypatch.setenv("WEED_EC_TILE_CACHE", "0")
    port = _port(d)
    refs = [RefEcVolume.load(d, VID, backend=b) for b in ("cpu", "tpu")]
    assert port.shard_ids() == refs[0].shard_ids() == [1, 2, 3, 4, 6, 7, 8, 9, 11, 12]
    assert port.tile_cache.enabled == (cache == "on")
    for nid, (off, size) in live.items():
        got = port.read_needle(nid)
        for ref in refs:
            want = ref.read_needle(nid)
            assert (got.id, got.cookie, bytes(got.data)) == (
                want.id, want.cookie, bytes(want.data)), nid
        assert port.read_span(off, get_actual_size(size, 3)) == _record(dat, off, size)
    if cache == "on":
        assert port.tile_cache.total_bytes > 0
    for ev in [port] + refs:
        ev.close()


@pytest.mark.parametrize("cache", ["on", "off"])
def test_random_spans_match_the_reference(six_mib, monkeypatch, cache):
    d, dat, _ = six_mib
    if cache == "off":
        monkeypatch.setenv("WEED_EC_TILE_CACHE", "0")
    port = _port(d)
    refs = [RefEcVolume.load(d, VID, backend=b) for b in ("cpu", "tpu")]
    rng = random.Random(7)
    for _ in range(32):
        off = rng.randrange(len(dat) - 1)
        size = rng.randrange(1, min(3 << 20, len(dat) - off) + 1)
        got = port.read_span(off, size)
        assert got == dat[off : off + size]
        for ref in refs:
            assert ref.read_span(off, size) == got
    for ev in [port] + refs:
        ev.close()


def test_geometry_and_lookup_match_the_reference(six_mib):
    d, _, live = six_mib
    port, ref = _port(d), RefEcVolume.load(d, VID, backend="cpu")
    assert port.dat_file_size() == ref.dat_file_size()
    assert port._nominal_shard_len() == ref._nominal_shard_len()
    assert port.serving_shard_ids() == ref.serving_shard_ids()
    for nid in list(live)[:20] + [10**9]:
        try:
            want = ref.locate_needle(nid)
        except KeyError:
            with pytest.raises(NeedleNotFound):
                port.locate_needle(nid)
            continue
        assert port.locate_needle(nid) == want
    port.close()
    ref.close()


# --- ported from tests/test_storage_engine.py::TestEcVolume -----------------


def test_full_local_read(small):
    d, _, live = small
    ev = _port(d)
    assert ev.shard_ids() == list(range(14))
    for k, (off, size) in live.items():
        assert ev.read_needle(k).id == k
    with pytest.raises(NeedleNotFound):
        ev.read_needle(13)  # deleted pre-encode
    ev.close()


def test_degraded_read_with_reconstruction(small):
    d, dat, live = small
    ev = _port(d)
    for sid in (0, 1, 11, 12):  # lose 4 shards including data shards
        ev.unmount_shard(sid)
        os.remove(os.path.join(d, str(VID)) + ec_files.to_ext(sid))
    for k, (off, size) in live.items():
        n = ev.read_needle(k)
        assert n.id == k
        assert ev.read_span(off, get_actual_size(size, 3)) == _record(dat, off, size)
    ev.close()


def test_too_many_lost_raises(small):
    d, _, live = small
    ev = _port(d)
    for sid in (0, 1, 2, 3, 4):
        ev.unmount_shard(sid)
        os.remove(os.path.join(d, str(VID)) + ec_files.to_ext(sid))
    with pytest.raises(NotEnoughShards):
        for k in live:
            ev.read_needle(k)
    ev.close()


def test_remote_fetch_seam(small):
    d, dat, live = small
    base = os.path.join(d, str(VID))
    # keep only shards 5..9 locally; serve 0..4 via the fetch callback
    stash = {}
    for sid in range(14):
        path = base + ec_files.to_ext(sid)
        if sid < 5 or sid >= 10:
            with open(path, "rb") as f:
                stash[sid] = f.read()
            os.remove(path)
    ev = _port(d)
    fetches = []

    def fetch(sid, off, size):
        if sid in stash:
            fetches.append(sid)
            chunk = stash[sid][off : off + size]
            return chunk + bytes(size - len(chunk))
        return None

    for k, (off, size) in live.items():
        assert ev.read_needle(k, fetch=fetch).id == k
        assert ev.read_span(off, get_actual_size(size, 3), fetch) == _record(dat, off, size)
    assert fetches, "remote seam must have been exercised"
    ev.close()


def test_ec_delete_journal(small):
    d, _, live = small
    base = os.path.join(d, str(VID))
    ev = _port(d)
    victim = next(iter(live))
    ev.delete_needle(victim)
    with pytest.raises(NeedleNotFound):
        ev.read_needle(victim)
    # journal holds the id; .ecx entry is tombstoned in place
    with open(base + ".ecj", "rb") as f:
        ecj = f.read()
    assert t.bytes_to_needle_id(ecj[:8]) == victim
    m = SortedNeedleMap.load(base + ".ecx")
    assert int(m.sizes[m.entry_index(victim)]) == t.TOMBSTONE_FILE_SIZE
    ev.delete_needle(victim)  # idempotent
    with open(base + ".ecj", "rb") as f:
        assert len(f.read()) == 8
    # the reference reads the same tombstone and journal
    ref = RefEcVolume.load(d, VID, backend="cpu")
    with pytest.raises(KeyError):
        ref.read_needle(victim)
    ref.close()
    ev.close()


def test_truncated_shard_self_heals_through_reconstruction(small):
    d, _, live = small
    base = os.path.join(d, str(VID))
    # all data lives in shard 0's first block: truncating below it
    # must reconstruct, and shards 1-3 (picked as survivors) must be
    # detected and skipped
    for s in (0, 1, 2, 3):
        with open(base + ec_files.to_ext(s), "r+b") as f:
            f.truncate(1024)
    ev = _port(d)
    for k in live:
        assert ev.read_needle(k).id == k
    assert all(s not in ev.shard_ids() for s in (0, 1, 2, 3))
    assert set(ev.quarantined) == {0, 1, 2, 3}
    for s in (0, 1, 2, 3):
        assert os.path.exists(base + ec_files.to_ext(s) + ".bad")
    ev.close()


def test_too_many_truncated_shards_fail_loudly(small):
    d, _, live = small
    base = os.path.join(d, str(VID))
    for s in range(5):
        with open(base + ec_files.to_ext(s), "r+b") as f:
            f.truncate(10)
    ev = _port(d)
    failures = 0
    for k in live:
        try:
            assert ev.read_needle(k).id == k
        except (NotEnoughShards, CorruptNeedle):
            failures += 1
    assert failures > 0, "truncating 5 shards of a tiny volume hit nothing"
    ev.close()


# --- what the port does differently -----------------------------------------


def test_load_refuses_a_tiered_volume(small):
    d, _, _ = small
    with open(os.path.join(d, f"{VID}.evf"), "w") as f:
        f.write('{"backend": "s3.default", "shard_size": 1048576, "shards": {}}')
    with pytest.raises(NotImplementedError, match="remote tier"):
        _port(d)


def test_load_needs_the_index(small):
    d, _, _ = small
    os.remove(os.path.join(d, f"{VID}.ecx"))
    with pytest.raises(FileNotFoundError):
        _port(d)


def test_codec_follows_backend_and_device(small):
    d, _, _ = small
    ev = _port(d)
    assert ev.rs._backend_name == "cuda" and ev.rs.device.type == "cpu"
    assert EcVolume(d, VID, backend="cpu").rs._backend_name == "cpu"
    ev.close()


def test_destroy_removes_shards_index_and_journal(small):
    d, _, live = small
    ev = _port(d)
    ev.delete_needle(next(iter(live)))
    ev.quarantine_shard(4, "test")
    ev.destroy()
    left = sorted(os.listdir(d))
    assert left == [f"{VID}.dat", f"{VID}.idx"]


# --- .ecx / .ecj / .idx / .ecc helpers against the reference ----------------


def test_idx_from_ec_index_matches_reference(small, tmp_path_factory):
    d, _, live = small
    ev = _port(d)
    for k in list(live)[3:6]:
        ev.delete_needle(k)
    ev.close()
    base = os.path.join(d, str(VID))
    other = str(tmp_path_factory.mktemp("ref")) + f"/{VID}"
    for ext in (".ecx", ".ecj"):
        shutil.copyfile(base + ext, other + ext)
    ec_files.write_idx_file_from_ec_index(base)
    ref_files.write_idx_file_from_ec_index(other)
    with open(base + ".idx", "rb") as a, open(other + ".idx", "rb") as b:
        got = a.read()
        assert got == b.read()
    seen, want = [], []
    with open(base + ".idx", "rb") as f:
        idx.walk_index_file(f, lambda *e: seen.append(e), rows_to_read=7)
        ref_idx.walk_index_file(f, lambda *e: want.append(e), rows_to_read=7)
    assert seen == want and len(seen) == len(got) // 16
    assert seen[-3:] == [(k, 0, t.TOMBSTONE_FILE_SIZE) for k in list(live)[3:6]]


def test_sorted_needle_map_matches_reference(small):
    d, _, live = small
    path = os.path.join(d, f"{VID}.ecx")
    port, ref = SortedNeedleMap.load(path), RefSortedNeedleMap.load(path)
    assert len(port) == len(ref)
    for arr in ("keys", "offsets", "sizes"):
        assert np.array_equal(getattr(port, arr), getattr(ref, arr))
    for k in list(live) + [13, 0, 10**6]:
        got, want = port.search(k), ref.search(k)
        assert (got is None) == (want is None)
        if got is not None:
            assert (got.key, got.offset, got.size, got.actual_offset) == (
                want.key, want.offset, want.size, want.actual_offset)
        assert port.entry_index(k) == ref.entry_index(k)


def test_volume_base_name_matches_reference():
    from seaweedfs_tpu.storage.volume import volume_base_name as ref_name

    for coll in ("", "pics"):
        assert volume_base_name("/d", coll, 7) == ref_name("/d", coll, 7)


@pytest.mark.parametrize("state", ["clean", "rebuilt", "rebuilt_republished", "corrupted"])
def test_sidecar_status_matches_reference(tmp_path, state):
    d = str(tmp_path)
    base = os.path.join(d, str(VID))
    write_volume(base, 400_000, 5, max_payload=20_000)
    stats = {}
    rs = new_encoder(backend="cuda", device="cpu")
    ec_files.write_ec_files(base, rs=rs, want_crcs=True, durable=True, stats=stats)
    assert ecc_sidecar.write_sidecar(base, stats["shard_crcs"]) is not None
    paths = {i: base + ec_files.to_ext(i) for i in range(14)}
    ecc_ns = os.stat(ecc_sidecar.sidecar_path(base)).st_mtime_ns
    # the filesystem clock can be coarse: place every mtime explicitly
    for p in paths.values():
        os.utime(p, ns=(ecc_ns - 10**9, ecc_ns - 10**9))
    if state.startswith("rebuilt"):
        os.remove(paths[3])
        st = {}
        ec_files.rebuild_ec_files(base, rs=rs, want_crcs=True, durable=True, stats=st)
        os.utime(paths[3], ns=(ecc_ns + 10**9, ecc_ns + 10**9))
        if state == "rebuilt_republished":
            ecc_sidecar.write_sidecar(base, st["shard_crcs"])
            later = ecc_ns + 2 * 10**9
            os.utime(ecc_sidecar.sidecar_path(base), ns=(later, later))
    elif state == "corrupted":
        # rot that keeps the size and the mtime: the status cannot see it
        st = os.stat(paths[6])
        with open(paths[6], "r+b") as f:
            f.seek(1234)
            b = f.read(1)
            f.seek(1234)
            f.write(bytes([b[0] ^ 0xFF]))
        os.utime(paths[6], ns=(st.st_atime_ns, st.st_mtime_ns))
    got = ecc_sidecar.sidecar_status(base, paths)
    want = ref_sidecar.sidecar_status(base, paths)
    assert got == want
    assert got[0] == {"clean": "ok", "rebuilt": "stale", "rebuilt_republished": "ok",
                      "corrupted": "ok"}[state]
    if state == "corrupted":
        assert got[1]["shards"]["6"]["crc"] != _file_crc(paths[6])
    assert ecc_sidecar.ecc_enabled() == ref_sidecar.ecc_enabled()


def test_sidecar_status_missing_and_short_shard(tmp_path):
    base = str(tmp_path / str(VID))
    paths = {0: base + ".ec00"}
    assert ecc_sidecar.sidecar_status(base, paths) == ("missing", None)
    with open(ecc_sidecar.sidecar_path(base), "w") as f:
        f.write('{"version": 1, "shards": {"0": {"crc": 1, "size": 5}}}')
    with open(paths[0], "wb") as f:
        f.write(b"1234")
    got = ecc_sidecar.sidecar_status(base, paths)
    assert got == ref_sidecar.sidecar_status(base, paths)
    assert got[0] == "stale"


def _file_crc(path: str) -> int:
    from seaweedfs_tpu_torch.util.crc import crc32c

    with open(path, "rb") as f:
        return crc32c(f.read())


def test_ecc_knob(monkeypatch):
    monkeypatch.setenv("WEED_EC_ECC", "0")
    assert not ecc_sidecar.ecc_enabled() and not ref_sidecar.ecc_enabled()


def test_stream_rebuild_with_remote_survivors_matches_reference(small, tmp_path_factory):
    """The rebuild's remote_readers without a session: remote survivors
    fill the gather, remote shards are not rebuilt, the bytes equal the
    reference rebuild's."""
    d, _, _ = small
    base = os.path.join(d, str(VID))
    shard = {}
    for i in range(14):
        with open(base + ec_files.to_ext(i), "rb") as f:
            shard[i] = f.read()
    other = str(tmp_path_factory.mktemp("ref_remote")) + f"/{VID}"
    for i in range(14):
        shutil.copyfile(base + ec_files.to_ext(i), other + ec_files.to_ext(i))
    remote = {}
    for b in (base, other):
        for i in (2, 6, 7, 8, 9):
            os.remove(b + ec_files.to_ext(i))
    for i in (7, 8, 9):
        remote[i] = lambda off, size, data=shard[i]: data[off : off + size]
    stats, rstats = {}, {}
    got = ec_stream.stream_rebuild_ec_files(
        base, remote_readers=remote, want_crcs=True, stats=stats, device="cpu")
    from seaweedfs_tpu.ec import ec_stream as ref_stream
    from seaweedfs_tpu.ec.codec import new_encoder as ref_encoder

    rfn, ffn = ref_stream.local_rebuild_fns(ref_encoder(backend="cpu"), want_crcs=True)
    want = ref_stream.stream_rebuild_ec_files(
        other, rebuild_fn=rfn, fetch_fn=ffn, remote_readers=remote,
        want_crcs=True, stats=rstats)
    assert got == want == [2, 6]
    for i in (2, 6):
        with open(base + ec_files.to_ext(i), "rb") as f:
            assert f.read() == shard[i]
    assert stats["shard_crcs"] == rstats["shard_crcs"]
