"""The port's VolumeServer against seaweedfs_tpu's, side by side on the CPU.

Both servers run standalone (no master) with scrub_interval=0 (the
port's scrub engine waits, and the port keeps the reference's default of
600 s, so it must be passed), the reference with ec_codec="cpu" and the
port with ec_codec="cuda" on device="cpu" (the kernels' plain
versions: K1 for tiles of 64 KiB and up, K5 below). Each test sends the
same request sequence to both, and `Volume._now_ns` is pinned in both
packages (the write path stamps append_at_ns from the clock). The
tolerance is byte identity: raw HTTP replies (the Date header excepted),
.dat/.idx files, EC shards, .ecx and .ecc, rebuilt shards and degraded
reads with the tile cache on and off. The gRPC verbs go through the
reference's own `rpc.volume_stub`, which is how the port's wire
contract is checked.
"""

import itertools
import json
import os
import shutil
import socket
import threading

import grpc
import numpy as np
import pytest

import seaweedfs_tpu.storage.volume as ref_volume
import seaweedfs_tpu_torch.storage.volume as port_volume
from seaweedfs_tpu.pb import rpc, volume_pb2 as pb
from seaweedfs_tpu.server.volume_server import VolumeServer as RefServer
from seaweedfs_tpu.util.availability import free_port
from seaweedfs_tpu_torch.ec import codec_cuda
from seaweedfs_tpu_torch.server.volume_server import VolumeServer as PortServer

VID = 7
LOST = (0, 5, 10, 13)
TS = "1700000000"


@pytest.fixture
def pinned_clock(monkeypatch):
    for mod in (ref_volume, port_volume):
        counter = itertools.count(1_700_000_000_000_000_000, 1000)
        monkeypatch.setattr(
            mod.Volume, "_now_ns", lambda self, c=counter: next(c)
        )


def _start(kind, directory, **kw):
    if kind == "ref":
        vs = RefServer([directory], port=free_port(), ec_codec="cpu",
                       scrub_interval=0, **kw)
    else:
        vs = PortServer([directory], port=free_port(), ec_codec="cuda",
                        device="cpu", scrub_interval=0, **kw)
    vs.start()
    return vs


@pytest.fixture
def pair(tmp_path, pinned_clock):
    dirs = {k: str(tmp_path / k) for k in ("ref", "port")}
    for d in dirs.values():
        os.makedirs(d)
    servers = {k: _start(k, d) for k, d in dirs.items()}
    yield servers, dirs
    for vs in servers.values():
        vs.stop()


@pytest.fixture
def second(tmp_path):
    """A second server of each package, in directories of their own."""
    dirs = {k: str(tmp_path / f"{k}2") for k in ("ref", "port")}
    for d in dirs.values():
        os.makedirs(d)
    servers = {k: _start(k, d) for k, d in dirs.items()}
    yield servers, dirs
    for vs in servers.values():
        vs.stop()


def _stub(vs):
    ch = rpc.dial(f"127.0.0.1:{vs.grpc_port}")
    return ch, rpc.volume_stub(ch)


def _both(servers, verb, req):
    out = {}
    for k, vs in servers.items():
        ch, stub = _stub(vs)
        with ch:
            out[k] = getattr(stub, verb)(req, timeout=60)
    return out


def _raw(port, request: bytes) -> bytes:
    """One request on its own connection; the reply as raw bytes, the
    Date header removed."""
    with socket.create_connection(("127.0.0.1", port), timeout=30) as s:
        s.sendall(request)
        chunks = []
        while True:
            b = s.recv(1 << 16)
            if not b:
                break
            chunks.append(b)
    raw = b"".join(chunks)
    head, sep, body = raw.partition(b"\r\n\r\n")
    lines = [ln for ln in head.split(b"\r\n") if not ln.lower().startswith(b"date:")]
    return b"\r\n".join(lines) + sep + body


def _req(method, path, body=b"", headers=()):
    lines = [f"{method} {path} HTTP/1.1", "Host: x", "Connection: close"]
    lines += [f"{k}: {v}" for k, v in headers]
    if body or method == "POST":
        lines.append(f"Content-Length: {len(body)}")
    return ("\r\n".join(lines) + "\r\n\r\n").encode() + body


def _same(servers, request: bytes) -> bytes:
    got = {k: _raw(vs.port, request) for k, vs in servers.items()}
    assert got["ref"] == got["port"], (request[:120], got)
    return got["port"]


def _multipart(name, data, ctype):
    boundary = "----weedtestboundary"
    body = (
        f"--{boundary}\r\nContent-Disposition: form-data; name=\"file\"; "
        f"filename=\"{name}\"\r\nContent-Type: {ctype}\r\n\r\n"
    ).encode() + data + f"\r\n--{boundary}--\r\n".encode()
    return body, f"multipart/form-data; boundary={boundary}"


def _needles(seed=3, count=24):
    """(fid, body) pairs of log-uniform sizes from 100 B to 300 KiB."""
    rng = np.random.default_rng(seed)
    out = []
    for i in range(count):
        size = int(np.exp(rng.uniform(np.log(100), np.log(300 << 10))))
        cookie = int(rng.integers(1, 2**31))
        out.append((f"{VID},{i + 1:x}{cookie:08x}", rng.bytes(size)))
    return out


def _write_volume(servers, needles):
    _both(servers, "AllocateVolume", pb.AllocateVolumeRequest(volume_id=VID))
    etags = {}
    for i, (fid, body) in enumerate(needles):
        if i % 4 == 1:
            mp, ctype = _multipart(f"n{i}.bin", body, "application/x-test")
            reply = _same(servers, _req("POST", f"/{fid}?ts={TS}", mp,
                                        [("Content-Type", ctype)]))
        elif i % 4 == 2:
            reply = _same(servers, _req(
                "POST", f"/{fid}?ts={TS}", body,
                [("Content-Type", "image/png"), ("Seaweed-Owner", "port")]))
        else:
            reply = _same(servers, _req("POST", f"/{fid}?ts={TS}", body))
        head, _, js = reply.partition(b"\r\n\r\n")
        assert head.startswith(b"HTTP/1.1 201"), reply[:200]
        etags[fid] = json.loads(js)["eTag"]
    return etags


def _files(d, exts):
    return {e: open(os.path.join(d, f"{VID}{e}"), "rb").read() for e in exts}


def _ecc(d):
    with open(os.path.join(d, f"{VID}.ecc")) as f:
        return json.load(f)


SHARD_EXTS = tuple(f".ec{i:02d}" for i in range(14))


def test_http_replies_and_files_match(pair):
    servers, dirs = pair
    needles = _needles()
    etags = _write_volume(servers, needles)
    fid0, body0 = needles[0]
    for fid, body in needles:
        got = _same(servers, _req("GET", f"/{fid}"))
        assert got.endswith(body)
        _same(servers, _req("HEAD", f"/{fid}"))
    _same(servers, _req("GET", f"/{fid0}", headers=[("Range", "bytes=10-99")]))
    _same(servers, _req("GET", f"/{fid0}", headers=[("Range", "bytes=-17")]))
    _same(servers, _req("GET", f"/{fid0}", headers=[("Range", "bytes=5-")]))
    _same(servers, _req("GET", f"/{fid0}", headers=[("Range", "bytes=999999-")]))
    got = _same(servers, _req("GET", f"/{fid0}",
                              headers=[("If-None-Match", f'"{etags[fid0]}"')]))
    assert got.startswith(b"HTTP/1.1 304")
    _same(servers, _req("GET", f"/{fid0}", headers=[
        ("If-Modified-Since", "Wed, 21 Oct 2037 07:28:00 GMT")]))
    _same(servers, _req("GET", f"/{needles[1][0]}/n1.bin"))
    _same(servers, _req("GET", f"/{needles[2][0]}?dl=true"))
    # a deleted needle, a wrong cookie, an unknown volume, a bad fid
    dead = needles[3][0]
    assert _same(servers, _req("DELETE", f"/{dead}")).startswith(b"HTTP/1.1 202")
    assert _same(servers, _req("GET", f"/{dead}")).startswith(b"HTTP/1.1 404")
    _same(servers, _req("DELETE", f"/{dead}"))
    _same(servers, _req("GET", f"/{fid0[:-8]}deadbeef"))
    # an unknown volume: the reference's standalone server asks a master
    # it does not have and drops the connection (ROADMAP Queue 3); the
    # port answers its no-owner 404
    got = _raw(servers["port"].port, _req("GET", "/99,0100000001"))
    assert got.startswith(b"HTTP/1.1 404") and got.endswith(b'{"error": "volume not found"}')
    _same(servers, _req("GET", "/notafid"))
    _same(servers, _req("POST", f"/{VID},zz", b"x"))
    assert _files(dirs["ref"], (".dat", ".idx")) == _files(dirs["port"], (".dat", ".idx"))
    for k, vs in servers.items():
        st = json.loads(_raw(vs.port, _req("GET", "/status")).partition(b"\r\n\r\n")[2])
        assert st["Volumes"] == 1 and st["Scrub"] == {"Disabled": True}, (k, st)
        metrics = _raw(vs.port, _req("GET", "/metrics"))
        assert b"weed_http_request_total" in metrics


def _encode(servers, dirs):
    _both(servers, "VolumeMarkReadonly", pb.VolumeMarkReadonlyRequest(volume_id=VID))
    _both(servers, "VolumeEcShardsGenerate",
          pb.VolumeEcShardsGenerateRequest(volume_id=VID))
    exts = SHARD_EXTS + (".ecx",)
    assert _files(dirs["ref"], exts) == _files(dirs["port"], exts)
    assert _ecc(dirs["ref"]) == _ecc(dirs["port"])


def _degrade(servers, dirs):
    """Mount all shards, drop the .dat volume, lose LOST."""
    _both(servers, "VolumeEcShardsMount",
          pb.VolumeEcShardsMountRequest(volume_id=VID, shard_ids=list(range(14))))
    _both(servers, "VolumeDelete", pb.VolumeDeleteRequest(volume_id=VID))
    _both(servers, "VolumeEcShardsUnmount",
          pb.VolumeEcShardsUnmountRequest(volume_id=VID, shard_ids=list(LOST)))
    for d in dirs.values():
        for s in LOST:
            os.remove(os.path.join(d, f"{VID}.ec{s:02d}"))


def test_ec_verbs_and_degraded_reads_match(pair, monkeypatch):
    servers, dirs = pair
    needles = _needles(seed=5)
    _write_volume(servers, needles)
    _encode(servers, dirs)
    _degrade(servers, dirs)
    for fid, body in needles:
        assert _same(servers, _req("GET", f"/{fid}")).endswith(body)
    # the tile cache off: each GET decodes its exact interval (K5 under
    # 64 KiB); the cache reads the switch when the EC volume is made
    monkeypatch.setenv("WEED_EC_TILE_CACHE", "0")
    keep = [s for s in range(14) if s not in LOST]
    _both(servers, "VolumeEcShardsUnmount",
          pb.VolumeEcShardsUnmountRequest(volume_id=VID, shard_ids=keep))
    _both(servers, "VolumeEcShardsMount",
          pb.VolumeEcShardsMountRequest(volume_id=VID, shard_ids=keep))
    ev = servers["port"].store.find_ec_volume(VID)
    assert ev.tile_cache.capacity_bytes == 0
    for fid, body in needles:
        assert _same(servers, _req("GET", f"/{fid}")).endswith(body)
    # rebuild the lost shards from the survivors
    got = _both(servers, "VolumeEcShardsRebuild",
                pb.VolumeEcShardsRebuildRequest(volume_id=VID))
    assert list(got["ref"].rebuilt_shard_ids) == list(got["port"].rebuilt_shard_ids) == list(LOST)
    assert _files(dirs["ref"], SHARD_EXTS) == _files(dirs["port"], SHARD_EXTS)
    assert _ecc(dirs["ref"]) == _ecc(dirs["port"])
    # shard reads and blob deletes
    reads = _both_stream(servers, pb.VolumeEcShardReadRequest(
        volume_id=VID, shard_id=3, offset=100, size=70000))
    assert reads["ref"] == reads["port"] and len(reads["port"]) == 70000
    fid = needles[0][0]
    key = int(fid.split(",")[1][:-8], 16)
    _both(servers, "VolumeEcBlobDelete",
          pb.VolumeEcBlobDeleteRequest(volume_id=VID, file_key=key))
    assert _same(servers, _req("GET", f"/{fid}")).startswith(b"HTTP/1.1 404")
    _both(servers, "VolumeEcShardsDelete",
          pb.VolumeEcShardsDeleteRequest(volume_id=VID, shard_ids=[1, 2]))
    assert sorted(os.listdir(dirs["ref"])) == sorted(os.listdir(dirs["port"]))


# --- copy, tail and the batch EC verbs -----------------------------------
# Each runs on a server of each package and must leave the same bytes:
# .dat/.idx for copy and tail, shard files, .ecx and .ecc for the batch
# verbs.


def test_volume_copy_pulls_dat_and_idx(pair, second):
    servers, dirs = pair
    dests, dest_dirs = second
    _write_volume(servers, _needles(seed=11, count=10))
    _both(servers, "VolumeMarkReadonly", pb.VolumeMarkReadonlyRequest(volume_id=VID))
    got = {}
    for k in ("ref", "port"):
        ch, stub = _stub(dests[k])
        with ch:
            got[k] = stub.VolumeCopy(pb.VolumeCopyRequest(
                volume_id=VID, source_data_node=f"127.0.0.1:{servers[k].port}"), timeout=60)
    assert got["ref"].last_append_at_ns == got["port"].last_append_at_ns > 0
    exts = (".dat", ".idx")
    want = _files(dirs["ref"], exts)
    assert _files(dest_dirs["ref"], exts) == _files(dest_dirs["port"], exts) == want
    assert _files(dirs["port"], exts) == want
    # the copy is mounted: a second copy is refused, and GETs serve it
    for k in ("ref", "port"):
        ch, stub = _stub(dests[k])
        with ch, pytest.raises(grpc.RpcError) as err:
            stub.VolumeCopy(pb.VolumeCopyRequest(
                volume_id=VID, source_data_node=f"127.0.0.1:{servers[k].port}"), timeout=60)
        assert err.value.code() == grpc.StatusCode.ALREADY_EXISTS
    for fid, body in _needles(seed=11, count=10):
        assert _same(dests, _req("GET", f"/{fid}")).endswith(body)


def _tail(vs, since_ns=0, idle=1):
    ch, stub = _stub(vs)
    with ch:
        return [(r.needle_header, r.needle_body) for r in stub.VolumeTailSender(
            pb.VolumeTailSenderRequest(volume_id=VID, since_ns=since_ns,
                                       idle_timeout_seconds=idle), timeout=60)]


def test_tail_sender_follows_appends(pair):
    """A tail opened on the volume streams what is there, then the
    needles appended while it follows, and ends after the idle timeout;
    since_ns skips what came before."""
    servers, _ = pair
    first = _needles(seed=12, count=6)
    _write_volume(servers, first)
    streams = {}

    def follow(k):
        streams[k] = _tail(servers[k], idle=4)

    threads = [threading.Thread(target=follow, args=(k,)) for k in servers]
    for t in threads:
        t.start()
    later = [(f"{VID},{0x40 + i:x}0000beef", bytes([i]) * (5000 + 999 * i)) for i in range(4)]
    for fid, body in later:
        _same(servers, _req("POST", f"/{fid}?ts={TS}", body))
    for t in threads:
        t.join(timeout=60)
    assert not any(t.is_alive() for t in threads)
    assert streams["ref"] == streams["port"]
    bodies = b"".join(b for _, b in streams["port"])
    assert len(streams["port"]) == len(first) + len(later)
    assert all(body in bodies for _, body in later)
    # since_ns: only the needles appended after the sixth
    from seaweedfs_tpu_torch.storage.needle import Needle

    header, body = streams["port"][5]
    since = Needle.from_bytes(header + body, servers["port"].store.find_volume(VID).version
                              ).append_at_ns
    tails = {k: _tail(vs, since_ns=since) for k, vs in servers.items()}
    assert tails["ref"] == tails["port"] == streams["port"][6:]


def test_tail_receiver_applies_writes_and_tombstones(pair, second):
    servers, dirs = pair
    dests, dest_dirs = second
    needles = _needles(seed=13, count=8)
    _write_volume(servers, needles)
    for fid, _ in needles[:3]:
        _same(servers, _req("DELETE", f"/{fid}"))
    _both(dests, "AllocateVolume", pb.AllocateVolumeRequest(volume_id=VID))
    for k in ("ref", "port"):
        ch, stub = _stub(dests[k])
        with ch:
            stub.VolumeTailReceiver(pb.VolumeTailReceiverRequest(
                volume_id=VID, since_ns=0, idle_timeout_seconds=1,
                source_volume_server=f"127.0.0.1:{servers[k].port}"), timeout=60)
    exts = (".dat", ".idx")
    assert _files(dest_dirs["ref"], exts) == _files(dest_dirs["port"], exts)
    for fid, _ in needles[:3]:
        assert _same(dests, _req("GET", f"/{fid}")).startswith(b"HTTP/1.1 404")
    for fid, body in needles[3:]:
        assert _same(dests, _req("GET", f"/{fid}")).endswith(body)


BATCH = (VID, VID + 1, VID + 2)


def _batch_volumes(servers, dirs):
    """Three sealed volumes of different sizes in each server."""
    for vid in BATCH[1:]:
        _both(servers, "AllocateVolume", pb.AllocateVolumeRequest(volume_id=vid))
    _write_volume(servers, _needles(seed=14, count=10))
    for n, vid in enumerate(BATCH[1:]):
        rng = np.random.default_rng(vid)
        for i in range(4 + 3 * n):
            body = rng.bytes(int(rng.integers(2000, 120_000)))
            _same(servers, _req("POST", f"/{vid},{i + 1:x}0000cafe?ts={TS}", body))
    for vid in BATCH:
        _both(servers, "VolumeMarkReadonly", pb.VolumeMarkReadonlyRequest(volume_id=vid))


def _batch_files(d):
    return {vid: {e: open(os.path.join(d, f"{vid}{e}"), "rb").read()
                  for e in SHARD_EXTS + (".ecx",)} for vid in BATCH}


def test_batch_generate_matches_the_reference(pair):
    servers, dirs = pair
    _batch_volumes(servers, dirs)
    _both(servers, "VolumeEcShardsBatchGenerate",
          pb.VolumeEcShardsBatchGenerateRequest(volume_ids=list(BATCH)))
    assert _batch_files(dirs["ref"]) == _batch_files(dirs["port"])
    for vid in BATCH:
        assert _ecc_crcs(dirs["ref"], vid) == _ecc_crcs(dirs["port"], vid)


def test_batch_rebuild_matches_the_reference(pair):
    """Two damage signatures over three volumes, rebuilt by one verb."""
    servers, dirs = pair
    _batch_volumes(servers, dirs)
    _both(servers, "VolumeEcShardsBatchGenerate",
          pb.VolumeEcShardsBatchGenerateRequest(volume_ids=list(BATCH)))
    want = _batch_files(dirs["port"])
    for vid in BATCH:
        lost = (3,) if vid % 2 else LOST
        _both(servers, "VolumeEcShardsMount",
              pb.VolumeEcShardsMountRequest(volume_id=vid, shard_ids=list(range(14))))
        _both(servers, "VolumeDelete", pb.VolumeDeleteRequest(volume_id=vid))
        _both(servers, "VolumeEcShardsUnmount",
              pb.VolumeEcShardsUnmountRequest(volume_id=vid, shard_ids=list(lost)))
        for d in dirs.values():
            for sid in lost:
                os.remove(os.path.join(d, f"{vid}.ec{sid:02d}"))
    _both(servers, "VolumeEcShardsBatchRebuild",
          pb.VolumeEcShardsBatchGenerateRequest(volume_ids=list(BATCH)))
    assert _batch_files(dirs["ref"]) == _batch_files(dirs["port"]) == want
    for vid in BATCH:
        assert _ecc_crcs(dirs["ref"], vid) == _ecc_crcs(dirs["port"], vid)


def test_batch_codec_is_the_servers_device_or_its_host_codec(tmp_path, monkeypatch):
    """device="cpu": a one-device mesh of plain versions; a host codec
    named by ec_codec: the host arm; neither falls back to the other."""
    from seaweedfs_tpu_torch.ec import ec_stream
    from seaweedfs_tpu_torch.parallel import MeshCodec

    port = PortServer([str(tmp_path)], port=free_port(), ec_codec="cuda", device="cpu",
                      scrub_interval=0)
    try:
        codec = port._batch_codec()
        assert isinstance(codec, MeshCodec)
        assert [str(d) for d in codec.mesh.devices.flat] == ["cpu"]
    finally:
        port.store.close()
    host = PortServer([str(tmp_path / "h")], port=free_port(), ec_codec="native",
                      device="cpu", scrub_interval=0)
    try:
        codec = host._batch_codec()
        assert isinstance(codec, ec_stream._HostBatchCodec)
        assert codec.rs._backend_name == "native"
    finally:
        host.store.close()


def _both_stream(servers, req):
    out = {}
    for k, vs in servers.items():
        ch, stub = _stub(vs)
        with ch:
            out[k] = b"".join(r.data for r in stub.VolumeEcShardRead(req, timeout=60))
    return out


def test_each_server_serves_what_the_other_wrote(pair, tmp_path):
    servers, dirs = pair
    needles = _needles(seed=9, count=12)
    _write_volume(servers, needles)
    # an EC copy of the same volume under another id, in both dirs
    for vs in servers.values():
        vs.stop()
    for d in dirs.values():
        for ext in (".dat", ".idx"):
            shutil.copyfile(os.path.join(d, f"{VID}{ext}"),
                            os.path.join(d, f"{VID + 1}{ext}"))
    swapped = {"ref": _start("ref", dirs["port"]), "port": _start("port", dirs["ref"])}
    servers.update(swapped)
    for fid, body in needles:
        assert _same(servers, _req("GET", f"/{fid}")).endswith(body)
    vid2 = VID + 1
    _both(servers, "VolumeMarkReadonly", pb.VolumeMarkReadonlyRequest(volume_id=vid2))
    _both(servers, "VolumeEcShardsGenerate",
          pb.VolumeEcShardsGenerateRequest(volume_id=vid2))
    _both(servers, "VolumeDelete", pb.VolumeDeleteRequest(volume_id=vid2))
    # restart on the other's directory again: the EC files written by
    # each are mounted and served by the other
    for vs in servers.values():
        vs.stop()
    servers.update({"ref": _start("ref", dirs["ref"]), "port": _start("port", dirs["port"])})
    _both(servers, "VolumeEcShardsMount",
          pb.VolumeEcShardsMountRequest(volume_id=vid2, shard_ids=list(range(14))))
    for fid, body in needles:
        fid2 = f"{vid2},{fid.split(',')[1]}"
        assert _same(servers, _req("GET", f"/{fid2}")).endswith(body)


def test_concurrent_generates_and_rebuild_under_degraded_reads(tmp_path, pinned_clock):
    """Two generates at once, and a rebuild while degraded GETs decode,
    on the port's server: the same shards and CRCs as one at a time."""
    d = str(tmp_path / "port")
    os.makedirs(d)
    vs = _start("port", d)
    try:
        ch, stub = _stub(vs)
        with ch:
            vols = {}
            for vid in (21, 22, 23):
                stub.AllocateVolume(pb.AllocateVolumeRequest(volume_id=vid))
                rng = np.random.default_rng(vid)
                vols[vid] = []
                for i in range(10):
                    fid = f"{vid},{i + 1:x}0000abcd"
                    body = rng.bytes(int(rng.integers(1000, 200_000)))
                    _raw(vs.port, _req("POST", f"/{fid}?ts={TS}", body))
                    vols[vid].append((fid, body))
                stub.VolumeMarkReadonly(pb.VolumeMarkReadonlyRequest(volume_id=vid))
            errors = []

            def generate(vid):
                try:
                    stub.VolumeEcShardsGenerate(
                        pb.VolumeEcShardsGenerateRequest(volume_id=vid), timeout=120)
                except grpc.RpcError as e:  # surfaced below
                    errors.append(e)

            threads = [threading.Thread(target=generate, args=(v,)) for v in (21, 22)]
            for t in threads:
                t.start()
            for t in threads:
                t.join(timeout=120)
            assert not errors and not any(t.is_alive() for t in threads)
            generate(23)  # alone: 23 holds 21's needles' shape
            # serial references: the same encodes one after the other
            serial = str(tmp_path / "serial")
            os.makedirs(serial)
            from seaweedfs_tpu_torch.ec import ec_files
            from seaweedfs_tpu_torch.ec.codec import new_encoder

            for vid in (21, 22):
                for ext in (".dat", ".idx"):
                    shutil.copyfile(os.path.join(d, f"{vid}{ext}"),
                                    os.path.join(serial, f"{vid}{ext}"))
                ec_files.write_ec_files(
                    os.path.join(serial, str(vid)),
                    rs=new_encoder(backend="cuda", device="cpu"))
                for ext in SHARD_EXTS:
                    with open(os.path.join(d, f"{vid}{ext}"), "rb") as a, open(
                        os.path.join(serial, f"{vid}{ext}"), "rb"
                    ) as b:
                        assert a.read() == b.read(), (vid, ext)
            # a rebuild of 21 while GETs of 21 decode around it
            stub.VolumeEcShardsMount(pb.VolumeEcShardsMountRequest(
                volume_id=21, shard_ids=list(range(14))))
            stub.VolumeDelete(pb.VolumeDeleteRequest(volume_id=21))
            stub.VolumeEcShardsUnmount(pb.VolumeEcShardsUnmountRequest(
                volume_id=21, shard_ids=list(LOST)))
            want = {s: open(os.path.join(d, f"21.ec{s:02d}"), "rb").read() for s in LOST}
            crcs = _ecc_crcs(d, 21)
            for s in LOST:
                os.remove(os.path.join(d, f"21.ec{s:02d}"))
            stop = threading.Event()
            bad = []

            def reader():
                while not stop.is_set():
                    for fid, body in vols[21]:
                        if not _raw(vs.port, _req("GET", f"/{fid}")).endswith(body):
                            bad.append(fid)

            readers = [threading.Thread(target=reader) for _ in range(3)]
            for t in readers:
                t.start()
            try:
                got = stub.VolumeEcShardsRebuild(
                    pb.VolumeEcShardsRebuildRequest(volume_id=21), timeout=120)
            finally:
                stop.set()
                for t in readers:
                    t.join(timeout=60)
            assert not bad and not any(t.is_alive() for t in readers)
            assert list(got.rebuilt_shard_ids) == list(LOST)
            for s in LOST:
                assert open(os.path.join(d, f"21.ec{s:02d}"), "rb").read() == want[s]
            assert _ecc_crcs(d, 21) == crcs
    finally:
        vs.stop()


def _ecc_crcs(d, vid):
    with open(os.path.join(d, f"{vid}.ecc")) as f:
        return json.load(f)


# item None: the master tier (ROADMAP item 7) and the scrub engine
# (item 9) are ported, and the parameters that waited for them are now
# taken as given
WAITS = [
    ({"master": "127.0.0.1:9333"}, None),
    ({"scrub_interval": 600.0}, None),
    ({"internal_port": 1}, "ROADMAP item 8"),
    ({"shard_writes": True}, "ROADMAP item 8"),
    ({"storage_backends": {"s3": {"default": {"enabled": True}}}}, "ROADMAP item 11"),
    ({"public_url": "10.0.0.1:8080"}, None),
    ({"data_center": "dc1"}, None),
    ({"rack": "r1"}, None),
    ({"announce": "10.0.0.1:8080"}, None),
    ({"heartbeat_interval": 5.0}, None),
    ({"read_redirect": True}, None),
    ({"n_writers": 4}, "ROADMAP item 8"),
]


@pytest.mark.parametrize("kw, item", WAITS, ids=[next(iter(k)) for k, _ in WAITS])
def test_waiting_parameters_raise(tmp_path, kw, item):
    args = {"scrub_interval": 0, **kw}
    if item is not None:
        with pytest.raises(NotImplementedError, match=item):
            PortServer([str(tmp_path)], port=free_port(), device="cpu", **args)
        return
    vs = PortServer([str(tmp_path)], port=free_port(), device="cpu", **args)
    try:
        (name, value), = kw.items()
        if name == "announce":
            assert f"{vs.announce_host}:{vs.announce_port}" == value
        elif name == "scrub_interval":
            assert vs.scrub.interval == value
        else:
            assert getattr(vs, name) == value
    finally:
        vs.store.close()


def test_the_reference_default_scrub_interval_raises(tmp_path):
    """It raised until the scrub engine was ported (ROADMAP item 9); the
    reference's default now builds the engine as the reference's does."""
    vs = PortServer([str(tmp_path)], device="cpu")
    os.makedirs(tmp_path / "ref")
    ref = RefServer([str(tmp_path / "ref")], ec_codec="cpu")
    try:
        assert (vs.scrub.interval, vs.scrub.rate_mb_s) == (ref.scrub.interval,
                                                           ref.scrub.rate_mb_s) == (600.0, 64.0)
    finally:
        vs.store.close()
        ref.store.close()


VERBS = [
    ("Query", pb.QueryRequest(), "ROADMAP item 11"),
    # ported with the tier engine (ROADMAP item 9): a volume that is not
    # there aborts NOT_FOUND, as the reference's does
    ("VolumeTierMoveDatToRemote", pb.VolumeTierMoveDatToRemoteRequest(), None),
    ("VolumeTierMoveDatFromRemote", pb.VolumeTierMoveDatFromRemoteRequest(), None),
    # ported with the master tier (ROADMAP item 7): they serve the request
    ("VolumeEcShardsCopy", pb.VolumeEcShardsCopyRequest(source_data_node="127.0.0.1:1"),
     None),
    ("CopyFile", pb.CopyFileRequest(volume_id=VID, ext=".dat"), None),
]


@pytest.mark.parametrize("verb, req, item", VERBS, ids=[v for v, _, _ in VERBS])
def test_waiting_verbs_raise(tmp_path, verb, req, item):
    vs = PortServer([str(tmp_path)], port=free_port(), device="cpu", scrub_interval=0)
    try:
        if item is not None:
            with pytest.raises(NotImplementedError, match=item):
                getattr(vs, verb)(req, None)
            return
        # a copy of nothing answers empty; CopyFile of a file that is
        # not there aborts NOT_FOUND, as the reference's does
        aborted = []

        class Context:
            def abort(self, code, message):
                aborted.append(code)
                raise grpc.RpcError(message)

        try:
            got = getattr(vs, verb)(req, Context())
            if verb != "VolumeEcShardsCopy":
                got = list(got)
        except grpc.RpcError:
            got = None
        assert (aborted, got) == (([], pb.VolumeEcShardsCopyResponse())
                                  if verb == "VolumeEcShardsCopy"
                                  else ([grpc.StatusCode.NOT_FOUND], None))
    finally:
        vs.store.close()


def test_server_runs_the_card_unless_asked(tmp_path, monkeypatch):
    """ec_codec="cuda" without device= means the card: without one the
    server refuses to come up rather than decode on the host."""
    import torch

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA device"):
        PortServer([str(tmp_path)], ec_codec="cuda", scrub_interval=0)
    vs = PortServer([str(tmp_path)], ec_codec="cuda", device="cpu", scrub_interval=0)
    try:
        rs = vs._new_rs()
        assert rs._backend_name == "cuda" and vs.store.device == "cpu"
        assert codec_cuda.SWAR_MIN_BYTES == 64 * 1024
    finally:
        vs.store.close()


def test_stop_ends_every_thread_start_made(tmp_path, monkeypatch):
    """stop() leaves no thread of the server running: the listeners, the
    gRPC workers, grpc's grace thread and the sampling profiler's thread
    all end (a thread that outlived it could still drive the card or
    hold its buffers). The grace thread must be seen by its name, which
    stop_server joins by: a grpc that named it otherwise fails here."""
    from seaweedfs_tpu_torch.pb import rpc as port_rpc
    from seaweedfs_tpu_torch.telemetry import profiler

    before = set(threading.enumerate())
    vs = _start("port", str(tmp_path))
    started, start = [], threading.Thread.start

    def record(t):
        started.append(t.name)
        return start(t)

    try:
        assert profiler.running() == profiler._ENABLED
        _both({"port": vs}, "AllocateVolume", pb.AllocateVolumeRequest(volume_id=VID))
        assert _raw(vs.port, _req("GET", "/status")).startswith(b"HTTP/1.1 200")
    finally:
        monkeypatch.setattr(threading.Thread, "start", record)
        vs.stop()
        monkeypatch.undo()
    assert any(port_rpc.GRACE_THREAD in n for n in started), started
    left = [t.name for t in threading.enumerate()
            if t not in before and t.name != "trace-drain"]
    assert left == [] and not profiler.running()


def test_sender_streams_and_receiver_applies(tmp_path):
    """tests/test_smallgaps.py::TestTailRpcs ported: on a port master
    with one port volume server, a tail of an assigned volume delivers
    the uploaded needle, and a second server replicates the volume
    through VolumeTailReceiver and serves it."""
    import time
    import urllib.request

    from seaweedfs_tpu_torch.client import operation as op
    from seaweedfs_tpu_torch.server.master_server import MasterServer

    master = MasterServer(port=free_port(), volume_size_limit_mb=64)
    master.start()
    vs = vs2 = None
    try:
        vs = PortServer([str(tmp_path / "tailvs")], port=free_port(),
                        master=f"127.0.0.1:{master.port}", heartbeat_interval=0.1,
                        max_volume_counts=[100], ec_codec="cuda", device="cpu",
                        scrub_interval=0)
        vs.start()
        deadline = time.time() + 45
        while time.time() < deadline and not master.topology.data_nodes():
            time.sleep(0.05)
        ar = op.assign(f"127.0.0.1:{master.port}", collection="tail")
        vid = int(ar.fid.split(",")[0])
        # incompressible: a text payload would be stored gzipped, and
        # this asserts on the raw tailed record bytes
        payload = bytes(range(256)) * 4
        assert not op.upload(f"{ar.url}/{ar.fid}", payload, jwt=ar.auth).error
        ch, stub = _stub(vs)
        with ch:
            frames = list(stub.VolumeTailSender(pb.VolumeTailSenderRequest(
                volume_id=vid, since_ns=0, idle_timeout_seconds=1), timeout=30))
        assert frames and payload in b"".join(f.needle_body for f in frames)
        vs2 = _start("port", str(tmp_path / "tailvs2"))
        ch, stub = _stub(vs2)
        with ch:
            stub.AllocateVolume(pb.AllocateVolumeRequest(
                volume_id=vid, collection="", replication="000"))
            stub.VolumeTailReceiver(pb.VolumeTailReceiverRequest(
                volume_id=vid, since_ns=0, idle_timeout_seconds=1,
                source_volume_server=f"{vs.host}:{vs.port}"), timeout=60)
        with urllib.request.urlopen(f"http://127.0.0.1:{vs2.port}/{ar.fid}",
                                    timeout=10) as r:
            assert r.read() == payload
    finally:
        for s in (vs2, vs):
            if s is not None:
                s.stop()
        master.stop()
