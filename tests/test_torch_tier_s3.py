"""The port's `s3` tier backend (seaweedfs_tpu_torch/storage/backend_s3.py)
against seaweedfs_tpu's, on the CPU.

tests/test_tier.py ported: for each package a data stack (a master and a
volume server with `s3.default` configured) and a remote-tier stack (a
master, a volume server, a memory filer and an S3 gateway with one
identity), all in this process (the port's volume servers run the
kernels' plain versions, device="cpu"). Each case runs on both
packages' stacks with the same inputs: the S3 client's PUT, ranged GETs
and DELETE; a volume's .dat moved to the bucket, its needles read
through ranged GETs, moved back byte-identical; a tiered volume reloaded
from its .vif. The replies and the bytes read are equal.

The EC case: one sealed volume, encoded and copied for each package,
mounted in a Store; tier_out_ec sends its 14 shards to each package's
`s3.default` (each over its own gateway); the objects of shards
{0, 5, 10, 13} are deleted through the S3 API; every needle then reads
back through the EcVolume, decoded from the remote survivors (the
port's on K1's plain version), equal to the reference's and to the .dat.
A port case: a remote-tier read holds no volume lock (a second read
overlaps it, and the serving loop's resolver declines the volume at
once). The tolerance everywhere is exact equality.
"""

import importlib
import os
import shutil
import time

import numpy as np
import pytest

from seaweedfs_tpu_torch.util.availability import free_port

SIDES = ("ref", "port")
PKG = {"ref": "seaweedfs_tpu", "port": "seaweedfs_tpu_torch"}
ACCESS, SECRET = "tier_access", "tier_secret"
BUCKET = "volume-tier"
VID = 41
LOST = (0, 5, 10, 13)


def mod(side, name):
    return importlib.import_module(f"{PKG[side]}.{name}")


def _kw(side):
    return dict(ec_codec="cpu") if side == "ref" else dict(ec_codec="cuda", device="cpu")


def _wait_nodes(master):
    deadline = time.time() + 45
    while time.time() < deadline and len(master.topology.data_nodes()) < 1:
        time.sleep(0.05)


@pytest.fixture(scope="module")
def tier_env(tmp_path_factory):
    """Per package: cluster A (data) and cluster B (the S3 remote tier)."""
    servers, out = [], {}

    def up(srv):
        srv.start()
        servers.append(srv)
        return srv

    try:
        for side in SIDES:
            master_cls = mod(side, "server.master_server").MasterServer
            volume_cls = mod(side, "server.volume_server").VolumeServer
            a = mod(side, "s3api.auth")
            m2 = up(master_cls(port=free_port(), volume_size_limit_mb=64))
            up(volume_cls([str(tmp_path_factory.mktemp(f"{side}_remote_vs"))],
                          port=free_port(), master=f"127.0.0.1:{m2.port}",
                          heartbeat_interval=0.2, max_volume_counts=[100], scrub_interval=0,
                          **_kw(side)))
            _wait_nodes(m2)
            f2 = up(mod(side, "server.filer_server").FilerServer(
                [f"127.0.0.1:{m2.port}"], port=free_port(), store="memory"))
            s3 = up(mod(side, "s3api.s3api_server").S3ApiServer(
                filer=f"127.0.0.1:{f2.port}", port=free_port(),
                iam=a.IdentityAccessManagement([a.Identity("tier", ACCESS, SECRET)])))
            backends = {"s3": {"default": {
                "enabled": True, "endpoint": f"127.0.0.1:{s3.port}", "bucket": BUCKET,
                "access_key": ACCESS, "secret_key": SECRET}}}
            m1 = up(master_cls(port=free_port(), volume_size_limit_mb=64))
            v1 = up(volume_cls([str(tmp_path_factory.mktemp(f"{side}_data_vs"))],
                               port=free_port(), master=f"127.0.0.1:{m1.port}",
                               heartbeat_interval=0.2, max_volume_counts=[100],
                               storage_backends=backends, scrub_interval=0, **_kw(side)))
            _wait_nodes(m1)
            mod(side, "s3api.client").S3Client(f"127.0.0.1:{s3.port}", ACCESS,
                                               SECRET).create_bucket(BUCKET)
            out[side] = (m1, v1, s3)
        yield out
    finally:
        for srv in reversed(servers):
            srv.stop()
        for side in SIDES:
            mod(side, "storage.backend").BACKEND_STORAGES.clear()


def _both(tier_env, fn):
    got = {side: fn(side, *tier_env[side]) for side in SIDES}
    assert got["port"] == got["ref"]
    return got["port"]


def test_put_get_range_delete(tier_env):
    payload = np.random.default_rng(1).bytes(2048)

    def run(side, _m1, _v1, s3):
        client = mod(side, "s3api.client")
        c = client.S3Client(f"127.0.0.1:{s3.port}", ACCESS, SECRET)
        c.put_object(BUCKET, "probe.bin", payload)
        out = [c.get_object(BUCKET, "probe.bin"), c.get_object(BUCKET, "probe.bin", 10, 16),
               c.get_object(BUCKET, "probe.bin", 2040)]
        c.delete_object(BUCKET, "probe.bin")
        with pytest.raises(client.S3ClientError) as e:
            c.get_object(BUCKET, "probe.bin")
        return out + [e.value.status]
    assert _both(tier_env, run) == [payload, payload[10:26], payload[2040:], 404]


def _move(side, v1, vid, collection, to_remote):
    rpc, pb = mod(side, "pb.rpc"), mod(side, "pb.volume_pb2")
    with rpc.dial(f"127.0.0.1:{v1.grpc_port}") as ch:
        stub = rpc.volume_stub(ch)
        if to_remote:
            list(stub.VolumeTierMoveDatToRemote(pb.VolumeTierMoveDatToRemoteRequest(
                volume_id=vid, collection=collection,
                destination_backend_name="s3.default"), timeout=120))
        else:
            list(stub.VolumeTierMoveDatFromRemote(pb.VolumeTierMoveDatFromRemoteRequest(
                volume_id=vid, collection=collection), timeout=120))


def test_upload_read_download(tier_env):
    """A volume's .dat moved to the bucket (the volume read-only, .dat
    gone, .vif written), every needle read over ranged GETs, then moved
    back byte-identical to the .dat before."""
    rng = np.random.default_rng(2)
    payloads = [rng.bytes(int(rng.integers(100, 30_000))) for _ in range(5)]

    def run(side, m1, v1, _s3):
        op = mod(side, "client.operation")
        fids = []
        for payload in payloads:
            ar = op.assign(f"127.0.0.1:{m1.port}", collection="up")
            assert not op.upload(f"{ar.url}/{ar.fid}", payload, jwt=ar.auth).error
            fids.append((ar.fid, payload))
        vid = int(fids[0][0].split(",")[0])
        vol = v1.store.find_volume(vid)
        with open(vol.base_name + ".dat", "rb") as f:
            before = f.read()
        _move(side, v1, vid, "up", True)
        state = (vol.has_remote_file(), vol.read_only, os.path.exists(vol.base_name + ".dat"),
                 os.path.exists(vol.base_name + ".vif"))
        mine = [(fid, p) for fid, p in fids if int(fid.split(",")[0]) == vid]
        remote = [op.download(f"{v1.host}:{v1.port}/{fid}")[0] == p for fid, p in mine]
        _move(side, v1, vid, "up", False)
        with open(vol.base_name + ".dat", "rb") as f:
            after = f.read()
        local = [op.download(f"{v1.host}:{v1.port}/{fid}")[0] == p for fid, p in mine]
        # how many of the needles the master put on this volume varies
        # with its growth: what must match is that each one read back
        return (state, bool(mine) and all(remote), vol.has_remote_file(), after == before,
                bool(mine) and all(local))
    assert _both(tier_env, run) == ((True, True, False, True), True, False, True, True)


def test_volume_reload_from_vif(tier_env):
    """A restarted server loads a tiered volume from .vif + .idx and
    reads its needle over the bucket."""
    payload = bytes(range(256)) * 4  # incompressible: the raw needle is compared

    def run(side, m1, v1, _s3):
        op = mod(side, "client.operation")
        ar = op.assign(f"127.0.0.1:{m1.port}", collection="reload")
        assert not op.upload(f"{ar.url}/{ar.fid}", payload, jwt=ar.auth).error
        vid = int(ar.fid.split(",")[0])
        _move(side, v1, vid, "reload", True)
        fresh = mod(side, "storage.disk_location").DiskLocation(
            v1.store.locations[0].directory, max_volume_count=100)
        fresh.load_existing_volumes()
        vol = fresh.volumes[vid]
        fid = mod(side, "storage.file_id").FileId.parse(ar.fid)
        try:
            return vol.has_remote_file(), vol.read_only, bytes(
                vol.read_needle(fid.key, fid.cookie).data)
        finally:
            fresh.close()
    assert _both(tier_env, run) == (True, True, payload)


def test_ec_shards_tiered_to_s3_decode_after_four_objects_are_lost(tier_env, tmp_path):
    """tier_out_ec to `s3.default` over each package's gateway, the
    objects of shards {0, 5, 10, 13} deleted: every needle reads back
    from the remote survivors, equal to the reference's and to the .dat;
    the port counts its ranged reads and the failed ones."""
    from seaweedfs_tpu_torch.ec import ec_files
    from seaweedfs_tpu_torch.ec.codec import new_encoder
    from seaweedfs_tpu_torch.stats.metrics import TIER_REMOTE_READ_ERRORS, TIER_REMOTE_READS
    from seaweedfs_tpu_torch.storage.needle import get_actual_size
    from seaweedfs_tpu_torch.storage.synthetic import write_volume

    src = tmp_path / "src"
    src.mkdir()
    base = str(src / str(VID))
    _, entries = write_volume(base, 12 << 20, 9, max_payload=512 << 10)
    ec_files.write_ec_files(base, rs=new_encoder(backend="cpu"))
    ec_files.write_sorted_file_from_idx(base)
    with open(base + ".dat", "rb") as f:
        dat = f.read()
    counters = {}

    def run(side, _m1, _v1, s3):
        d = tmp_path / side
        d.mkdir()
        for ext in [ec_files.to_ext(i) for i in range(14)] + [".ecx"]:
            shutil.copyfile(base + ext, str(d / str(VID)) + ext)
        kw = dict(ec_backend="cpu") if side == "ref" else dict(ec_backend="cuda", device="cpu")
        store = mod(side, "storage.store").Store([str(d)], [10], **kw)
        try:
            store.mount_ec_shards(VID, "", list(range(14)))
            summary = mod(side, "tier.ec_tier").tier_out_ec(store, VID, "s3.default")
            ev = store.find_ec_volume(VID)
            client = mod(side, "s3api.client").S3Client(f"127.0.0.1:{s3.port}", ACCESS,
                                                        SECRET)
            for sid in LOST:
                client.delete_object(BUCKET, ev.remote.shards[sid]["key"])
            reads0, errors0 = TIER_REMOTE_READS.value(), TIER_REMOTE_READ_ERRORS.value()
            got = [ev.read_span(off, get_actual_size(size, 3)) for _nid, off, size in entries]
            if side == "port":
                counters["reads"] = TIER_REMOTE_READS.value() - reads0
                counters["errors"] = TIER_REMOTE_READ_ERRORS.value() - errors0
            return (summary["Shards"], summary["Bytes"], sorted(ev.shards),
                    sorted(ev.remote.shards), got)
        finally:
            store.close()
    shards, nbytes, local, remote, got = _both(tier_env, run)
    assert shards == remote == list(range(14)) and local == []
    assert nbytes == 14 * os.path.getsize(base + ".ec00")
    assert got == [dat[off:off + get_actual_size(size, 3)] for _nid, off, size in entries]
    assert counters["reads"] > 0 and counters["errors"] > 0, counters


def test_remote_read_leaves_the_volume_lock_free(tmp_path, monkeypatch):
    """A read of a remote-tier volume is a network round trip (a ranged
    GET, which through the gateway may read chunks from this very
    server): it holds no volume lock, so a second read of the same
    volume overlaps it and the serving loop's resolver declines the
    volume at once instead of waiting (a port departure; the reference
    holds the lock across the GET)."""
    import threading

    from seaweedfs_tpu_torch.server.volume_server import make_needle_plan_core
    from seaweedfs_tpu_torch.storage import backend as bk
    from seaweedfs_tpu_torch.storage import backend_dir
    from seaweedfs_tpu_torch.storage.file_id import FileId
    from seaweedfs_tpu_torch.storage.needle import Needle
    from seaweedfs_tpu_torch.storage.volume import Volume

    bk.ensure_builtin_factories()
    bk.load_backend_config({"dir": {"locktest": {"enabled": True,
                                                 "dir": str(tmp_path / "remote")}}})
    rng = np.random.default_rng(3)
    bodies = {nid: rng.bytes(int(rng.integers(1000, 90_000))) for nid in (1, 2)}
    v = Volume(str(tmp_path), 5)
    try:
        for nid, body in bodies.items():
            v.write_needle(Needle(id=nid, cookie=7, data=body))
        v.tier_upload("dir.locktest")
        gate, entered = threading.Event(), threading.Event()
        real = backend_dir.DirStorageFile.read_at

        def held(self, length, offset):
            if not entered.is_set():
                entered.set()
                assert gate.wait(30)
            return real(self, length, offset)

        monkeypatch.setattr(backend_dir.DirStorageFile, "read_at", held)
        first = {}
        t = threading.Thread(target=lambda: first.update(n=v.read_needle(1, 7)))
        t.start()
        assert entered.wait(30)
        plan = make_needle_plan_core()
        t0 = time.monotonic()
        declined = plan(v, FileId(5, 2, 7), None, False, 0, False)
        second = v.read_needle(2, 7)  # overlaps the held read
        waited = time.monotonic() - t0
        gate.set()
        t.join(30)
        assert declined is None and waited < 5, waited
        assert bytes(second.data) == bodies[2] and bytes(first["n"].data) == bodies[1]
    finally:
        v.close()
        bk.BACKEND_STORAGES.pop("dir.locktest", None)
