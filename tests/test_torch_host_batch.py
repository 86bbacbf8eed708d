"""The port's batch host arm against seaweedfs_tpu's, on the CPU.

The reference takes its host arm (ec_stream._HostBatchCodec over the
native shim) whenever JAX has only CPU devices, as under this conftest.
The port takes it only when asked: a _HostBatchCodec passed in, or
codec=None with WEED_EC_CODEC naming a host codec. The same damaged
shard sets, two signature groups, go through both, inline (at most
_HOST_INLINE_TILES work items) and threaded; the rebuilt files and
their CRCs must be equal byte for byte, to the reference's and to the
port's K2 arm (MeshCodec on a CPU device, K2's plain version).
Tolerance: byte identity everywhere.
"""

import os
import shutil

import numpy as np
import pytest
import torch

from seaweedfs_tpu.ec import ec_files as ref_files
from seaweedfs_tpu.ec import ec_stream as ref_stream
from seaweedfs_tpu_torch.ec import ec_files, ec_stream
from seaweedfs_tpu_torch.ec.codec import new_encoder
from seaweedfs_tpu_torch.parallel import MeshCodec, make_mesh
from seaweedfs_tpu_torch.util.crc import crc32c
from tests.test_torch_ec_batch import BLOCKS, _damage, _lost, _read, _volumes
from tests.test_torch_ec_files import SHARDS


def _copy_sets(src, dst) -> None:
    for s, d in zip(src, dst):
        for ext in SHARDS:
            if os.path.exists(s + ext):
                shutil.copyfile(s + ext, d + ext)


def _encoded(tmp_path, n: int, seed: int, base_bytes: int = 60_000):
    refs, ports = _volumes(tmp_path, n, seed=seed, base_bytes=base_bytes)
    ref_files.write_ec_files_batch(refs, **BLOCKS)
    _copy_sets(refs, ports)
    return refs, ports


@pytest.mark.parametrize(
    "tile, inline", [(65536, True), (1024, False)], ids=["inline", "threaded"]
)
@pytest.mark.parametrize("backend", ["native", "cpu"])
def test_rebuild_matches_reference_and_k2(tmp_path, tile, inline, backend):
    refs, ports = _encoded(tmp_path, 4, seed=70)
    originals = _damage(refs, ports, _lost)
    k2 = [str(tmp_path / "k2" / os.path.basename(p)) for p in ports]
    os.makedirs(tmp_path / "k2")
    _copy_sets(ports, k2)
    rs, ps, ks = {}, {}, {}
    want = ref_stream.stream_rebuild_ec_files_batch(
        refs, tile_bytes=tile, stats=rs, want_crcs=True
    )
    assert rs["codec_arm"] == "host" and rs.get("host_inline", False) == inline
    host = ec_stream._HostBatchCodec(new_encoder(backend=backend))
    got = ec_files.rebuild_ec_files_batch(
        ports, codec=host, tile_bytes=tile, stats=ps, want_crcs=True, durable=True
    )
    assert got == want == [list(_lost(v)) for v in range(4)]
    assert ps["codec_arm"] == "host" and ps.get("host_inline", False) == inline
    assert ps["batch_groups"] == rs["batch_groups"] == 2
    assert ps["shard_crcs"] == rs["shard_crcs"]
    for r, p in zip(refs, ports):
        for ext in SHARDS:
            assert _read(r + ext) == _read(p + ext), (p, ext)
    for (v, i), blob in originals.items():
        assert _read(ports[v] + ec_files.to_ext(i)) == blob
        assert ps["shard_crcs"][v][i] == crc32c(blob)
    # the card's arm (K2's plain version here) rebuilds the same bytes
    ec_files.rebuild_ec_files_batch(
        k2, codec=MeshCodec(make_mesh(["cpu"])), tile_bytes=tile, stats=ks, want_crcs=True
    )
    assert ks["shard_crcs"] == ps["shard_crcs"] and "codec_arm" not in ks
    for a, b in zip(k2, ports):
        for ext in SHARDS:
            assert _read(a + ext) == _read(b + ext)


@pytest.mark.parametrize("env", ["native", "cpu"])
def test_codec_none_takes_the_host_arm_when_named(tmp_path, monkeypatch, env):
    monkeypatch.setenv("WEED_EC_CODEC", env)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    refs, ports = _encoded(tmp_path, 3, seed=80, base_bytes=30_000)
    _damage(refs, ports, _lost)
    ps = {}
    ref_files.rebuild_ec_files_batch(refs, tile_bytes=8192)
    ec_files.rebuild_ec_files_batch(ports, tile_bytes=8192, stats=ps)
    assert ps["codec_arm"] == "host"
    for r, p in zip(refs, ports):
        for ext in SHARDS:
            assert _read(r + ext) == _read(p + ext)


@pytest.mark.parametrize("pipeline", ["1", "0"])
def test_no_card_and_no_request_raises(tmp_path, monkeypatch, pipeline):
    monkeypatch.delenv("WEED_EC_CODEC", raising=False)
    monkeypatch.setenv("WEED_EC_PIPELINE", pipeline)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    refs, ports = _encoded(tmp_path, 2, seed=85, base_bytes=30_000)
    _damage(refs, ports, _lost)
    with pytest.raises(RuntimeError):
        ec_files.rebuild_ec_files_batch(ports)
    with pytest.raises(RuntimeError):
        ec_files.write_ec_files_batch(ports)
    assert not any(
        os.path.exists(p + ec_files.to_ext(i)) for v, p in enumerate(ports) for i in _lost(v)
    )


def test_serial_arm_on_the_host_codec(tmp_path, monkeypatch):
    monkeypatch.setenv("WEED_EC_PIPELINE", "0")
    refs, ports = _encoded(tmp_path, 2, seed=90)
    _damage(refs, ports, _lost)
    rs, ps = {}, {}
    ref_files.rebuild_ec_files_batch(refs, stats=rs, want_crcs=True)
    host = ec_stream._HostBatchCodec(new_encoder(backend="native"))
    ec_files.rebuild_ec_files_batch(ports, codec=host, stats=ps, want_crcs=True)
    assert ps["shard_crcs"] == rs["shard_crcs"]
    for r, p in zip(refs, ports):
        for ext in SHARDS:
            assert _read(r + ext) == _read(p + ext)


@pytest.mark.parametrize("pipeline", ["1", "0"])
def test_batch_encode_host_route(tmp_path, monkeypatch, pipeline):
    monkeypatch.setenv("WEED_EC_PIPELINE", pipeline)
    refs, ports = _volumes(tmp_path, 3, seed=95)
    k2 = [str(tmp_path / "k2" / os.path.basename(p)) for p in ports]
    os.makedirs(tmp_path / "k2")
    for p, k in zip(ports, k2):
        shutil.copyfile(p + ".dat", k + ".dat")
    rs, ps, ks = {}, {}, {}
    ref_files.write_ec_files_batch(refs, stats=rs, want_crcs=True, **BLOCKS)
    host = ec_stream._HostBatchCodec(new_encoder(backend="native"))
    ec_files.write_ec_files_batch(ports, codec=host, stats=ps, want_crcs=True,
                                  durable=True, **BLOCKS)
    assert ps["codec_arm"] == "host"
    assert ps["shard_crcs"] == rs["shard_crcs"]
    for r, p in zip(refs, ports):
        for ext in SHARDS:
            assert _read(r + ext) == _read(p + ext)
    ec_files.write_ec_files_batch(k2, codec=MeshCodec(make_mesh(["cpu"])), stats=ks,
                                  want_crcs=True, **BLOCKS)
    assert ks["shard_crcs"] == ps["shard_crcs"]
    for a, b in zip(k2, ports):
        for ext in SHARDS:
            assert _read(a + ext) == _read(b + ext)


@pytest.mark.parametrize("tile", [65536, 1024], ids=["inline", "threaded"])
def test_host_arm_abort_removes_every_target(tmp_path, tile):
    refs, ports = _encoded(tmp_path, 3, seed=99)
    _damage(refs, ports, _lost)
    # a truncated survivor of the last volume fails the chunk (not its
    # first survivor, whose length sets the volume's tile walk)
    with open(ports[2] + ec_files.to_ext(2), "r+b") as f:
        f.truncate(100)
    host = ec_stream._HostBatchCodec(new_encoder(backend="native"))
    with pytest.raises(ValueError, match="truncated"):
        ec_files.rebuild_ec_files_batch(ports, codec=host, tile_bytes=tile)
    for v, p in enumerate(ports):
        for i in _lost(v):
            assert not os.path.exists(p + ec_files.to_ext(i))
