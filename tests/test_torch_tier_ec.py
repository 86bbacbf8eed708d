"""The port's EcVolume remote tier against seaweedfs_tpu's, on the CPU.

One sealed volume is encoded by the port and copied for each package.
Shards are uploaded to a `dir` backend (each package's own registry and
directory) and attached through the `.evf` sidecar; their local copies
go. The port's EcVolume (cuda backend, device="cpu": K1's plain
version) and the reference's (cpu backend) then serve every needle,
local, remote and reconstructed with remote survivors, and reload
through DiskLocation and Store. A ChaosBackendStorage that fails every
read makes both degrade to reconstruction without quarantining
anything, and heal. Tolerance: byte identity of every read.
"""

import itertools
import os
import shutil

import pytest

import seaweedfs_tpu.ec.ec_volume as ref_ec_volume
import seaweedfs_tpu.storage.backend as ref_backend
import seaweedfs_tpu.storage.backend_chaos as ref_chaos
import seaweedfs_tpu.storage.disk_location as ref_disk_location
import seaweedfs_tpu.storage.store as ref_store
import seaweedfs_tpu_torch.ec.ec_volume as port_ec_volume
import seaweedfs_tpu_torch.storage.backend as port_backend
import seaweedfs_tpu_torch.storage.backend_chaos as port_chaos
import seaweedfs_tpu_torch.storage.disk_location as port_disk_location
import seaweedfs_tpu_torch.storage.store as port_store
from seaweedfs_tpu_torch.ec import ec_files
from seaweedfs_tpu_torch.ec.codec import new_encoder
from seaweedfs_tpu_torch.stats.metrics import TIER_REMOTE_READ_ERRORS, TIER_REMOTE_READS
from seaweedfs_tpu_torch.storage.needle import get_actual_size
from seaweedfs_tpu_torch.storage.synthetic import write_volume

VID = 7
_names = itertools.count()


class _Side:
    """One package's modules and its copy of the volume."""

    def __init__(self, name, ec_volume, backend, chaos, disk_location, store, kw):
        self.name = name
        self.ec_volume = ec_volume
        self.backend = backend
        self.chaos = chaos
        self.disk_location = disk_location
        self.store = store
        self.kw = kw  # how this side runs its codec on the CPU

    def load(self, d):
        return self.ec_volume.EcVolume.load(d, VID, **self.kw)


REF = _Side("ref", ref_ec_volume, ref_backend, ref_chaos, ref_disk_location, ref_store,
            {"backend": "cpu"})
PORT = _Side("port", port_ec_volume, port_backend, port_chaos, port_disk_location,
             port_store, {"backend": "cuda", "device": "cpu"})


@pytest.fixture(scope="module")
def sealed(tmp_path_factory):
    """A ~3 MiB volume (one small row: data on shards 0-2), encoded."""
    d = str(tmp_path_factory.mktemp("sealed"))
    base = os.path.join(d, str(VID))
    _, entries = write_volume(base, 3 << 20, 5, max_payload=200 << 10)
    ec_files.write_ec_files(base, rs=new_encoder(backend="cpu"))
    ec_files.write_sorted_file_from_idx(base)
    with open(base + ".dat", "rb") as f:
        dat = f.read()
    return d, dat, entries


@pytest.fixture
def sides(sealed, tmp_path):
    """Each side's copy of the shard set and .ecx (no .dat), and a `dir`
    backend of its own registered under one fresh name."""
    d0, dat, entries = sealed
    name = f"dir.tier{next(_names)}"
    out = []
    for side in (REF, PORT):
        d = str(tmp_path / side.name)
        os.makedirs(d)
        for ext in [ec_files.to_ext(i) for i in range(14)] + [".ecx"]:
            shutil.copyfile(os.path.join(d0, str(VID)) + ext, os.path.join(d, str(VID)) + ext)
        side.backend.ensure_builtin_factories()
        side.backend.load_backend_config({"dir": {name.split(".")[1]: {
            "enabled": True, "dir": str(tmp_path / f"{side.name}_remote")}}})
        out.append((side, d))
    yield out, name, dat, entries
    for side in (REF, PORT):
        side.backend.BACKEND_STORAGES.pop(name, None)


def _tier(side, d, name, sids) -> None:
    """Upload `sids` to the backend, attach them, drop the local copies."""
    ev = side.load(d)
    storage = side.backend.get_backend(name)
    shards = {}
    for sid in sids:
        path = os.path.join(d, str(VID)) + ec_files.to_ext(sid)
        key, size = storage.copy_file(path, {"volumeId": str(VID), "ext": ec_files.to_ext(sid)})
        shards[sid] = {"key": key, "size": size}
    size = os.path.getsize(os.path.join(d, str(VID)) + ec_files.to_ext(sids[0]))
    ev.attach_remote(side.ec_volume.RemoteEcAttachment(name, size, shards))
    for sid in sids:
        ev.unmount_shard(sid)
        os.remove(os.path.join(d, str(VID)) + ec_files.to_ext(sid))
    ev.close()


def _lose(d, sids) -> None:
    for sid in sids:
        os.remove(os.path.join(d, str(VID)) + ec_files.to_ext(sid))


def _reads(ev, dat, entries):
    got = []
    for _nid, off, size in entries:
        span = get_actual_size(size, 3)
        blob = ev.read_span(off, span)
        assert blob == dat[off : off + span]
        got.append(blob)
    return got


def test_attach_serves_remote_shards_and_decodes_with_them(sides):
    pair, name, dat, entries = sides
    reads = []
    for side, d in pair:
        _tier(side, d, name, (1, 2))
        _lose(d, (0, 5, 10, 13))
        remote0, errors0 = TIER_REMOTE_READS.value(), TIER_REMOTE_READ_ERRORS.value()
        ev = side.load(d)
        assert ev.remote is not None and sorted(ev.remote.shards) == [1, 2]
        assert ev.serving_shard_ids() == [1, 2, 3, 4, 6, 7, 8, 9, 11, 12]
        reads.append(_reads(ev, dat, entries))
        if side is PORT:
            # shard 0's bytes decode from 8 local survivors and the two
            # remote ones; shards 1 and 2 come straight from the backend
            assert TIER_REMOTE_READS.value() > remote0
            assert TIER_REMOTE_READ_ERRORS.value() == errors0
            assert not ev.quarantined
        ev.close()
    assert reads[0] == reads[1]


def test_reload_through_disk_location_and_store(sides):
    pair, name, dat, entries = sides
    beats = []
    for side, d in pair:
        _tier(side, d, name, (1, 2))
        _lose(d, (0,))
        loc = side.disk_location.DiskLocation(d, ec_backend=side.kw["backend"],
                                              **({"device": "cpu"} if side is PORT else {}))
        loc.load_existing_volumes()
        ev = loc.ec_volumes[VID]
        assert ev.remote is not None and ev.shard_ids() == [3, 4, 5, 6, 7, 8, 9, 10, 11, 12, 13]
        _reads(ev, dat, entries[::7])
        loc.close()
        store = side.store.Store([d], ec_backend=side.kw["backend"],
                                 **({"device": "cpu"} if side is PORT else {}))
        hb = store.collect_heartbeat()
        beats.append([(s.id, s.collection, s.ec_index_bits) for s in hb.ec_shards])
        for nid, off, size in entries[::11]:
            assert bytes(store.read_needle(VID, nid).data) == bytes(
                store.find_ec_volume(VID).read_needle(nid).data)
        store.close()
    # shards 1-13 serve here (1 and 2 remotely); shard 0 is lost
    assert beats[0] == beats[1] == [(VID, "", (1 << 14) - 2)]


def test_fully_tiered_volume_serves_from_the_backend(sides):
    pair, name, dat, entries = sides
    for side, d in pair:
        _tier(side, d, name, tuple(range(14)))
        ev = side.load(d)
        assert ev.shard_ids() == [] and ev.serving_shard_ids() == list(range(14))
        _reads(ev, dat, entries[::5])
        ev.close()


def test_backend_faults_degrade_to_decode_and_heal(sides):
    pair, name, dat, entries = sides
    for side, d in pair:
        _tier(side, d, name, (1, 2))
        _lose(d, (0,))
        inner = side.backend.get_backend(name)
        chaos = side.chaos.ChaosBackendStorage(
            inner, [side.chaos.BackendFault("eio", ("read",))], seed=3)
        side.backend.register_backend(chaos)
        try:
            errors0 = TIER_REMOTE_READ_ERRORS.value()
            ev = side.load(d)
            _reads(ev, dat, entries)  # shards 1 and 2 reconstruct from the locals
            assert chaos.raised > 0 and not ev.quarantined
            assert sorted(ev.remote.shards) == [1, 2]
            if side is PORT:
                assert TIER_REMOTE_READ_ERRORS.value() > errors0
            chaos.heal()
            raised = chaos.raised
            ev.tile_cache.invalidate()
            reads0 = TIER_REMOTE_READS.value()
            _reads(ev, dat, entries)
            assert chaos.raised == raised
            if side is PORT:
                assert TIER_REMOTE_READS.value() > reads0
            ev.close()
        finally:
            side.backend.register_backend(inner)


def test_detach_after_tiering_back_in(sides):
    pair, name, dat, entries = sides
    for side, d in pair:
        _tier(side, d, name, (1, 2))
        ev = side.load(d)
        storage = side.backend.get_backend(name)
        for sid, info in ev.remote.shards.items():
            storage.download_file(os.path.join(d, str(VID)) + ec_files.to_ext(sid), info["key"])
            ev.mount_shard(sid)
        old = ev.detach_remote()
        assert sorted(old.shards) == [1, 2] and ev.remote is None
        assert not os.path.exists(ev.evf_path)
        assert ev.serving_shard_ids() == list(range(14))
        _reads(ev, dat, entries[::3])
        ev.close()
        again = side.load(d)
        assert again.remote is None
        again.close()


def test_unreadable_sidecar_is_ignored(sides):
    pair, _, dat, entries = sides
    for side, d in pair:
        with open(os.path.join(d, f"{VID}.evf"), "w") as f:
            f.write("{not json")
        ev = side.load(d)
        assert ev.remote is None
        _reads(ev, dat, entries[::9])
        ev.destroy()
        assert not os.path.exists(os.path.join(d, f"{VID}.evf"))
