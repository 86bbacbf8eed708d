"""The port's batch EC drivers against seaweedfs_tpu's, end to end on the
CPU: sealed volumes written by the reference's storage code from a seed
are encoded and rebuilt in batches by both packages, and every shard
file, the .ecx and the shard CRCs must be equal byte for byte, with the
same structural stats.

The reference runs its MeshCodec on the conftest's virtual CPU devices;
the port runs its MeshCodec on torch.device("cpu") meshes of the same
shape, where K2, K3 and K4 run their plain versions (the kernels are
held against those on the card, tests/test_torch_cuda.py).
"""

import errno
import os
import shutil
import threading

import jax
import numpy as np
import pytest
import torch

from seaweedfs_tpu.ec import ec_files as ref_files
from seaweedfs_tpu.ec import ec_stream as ref_stream
from seaweedfs_tpu.parallel import MeshCodec as RefMeshCodec
from seaweedfs_tpu.parallel import make_mesh as ref_make_mesh
from seaweedfs_tpu_torch import trace
from seaweedfs_tpu_torch.ec import ec_files, ec_stream
from seaweedfs_tpu_torch.ec.codec import new_encoder
from seaweedfs_tpu_torch.parallel import MeshCodec, make_mesh
from seaweedfs_tpu_torch.util.crc import crc32c
from tests.test_torch_ec_files import SHARDS, _write_volume

# small-tier rows of 10 x 4 KiB: a volume of ~100 KB is a few rounds
BLOCKS = dict(large_block_size=1 << 20, small_block_size=4096)
STRUCT = ("batch_volumes", "mesh", "ring_slots", "pipeline_depth")


def _codecs(vol: int, stripe: int):
    devs = jax.devices()
    n = vol * stripe
    if len(devs) < n:
        pytest.skip("needs the conftest's virtual CPU devices")
    ref = RefMeshCodec(ref_make_mesh(devs[:n], stripe=stripe))
    port = MeshCodec(make_mesh(["cpu"] * n, stripe=stripe), matrix=ref.matrix)
    return ref, port


def _volumes(tmp_path, n: int, seed: int = 0, base_bytes: int = 60_000):
    """n volume pairs (reference dir, port dir) of different sizes."""
    refs, ports = [], []
    for v in range(n):
        ref = str(tmp_path / "ref" / f"{v + 1}")
        port = str(tmp_path / "port" / f"{v + 1}")
        os.makedirs(os.path.dirname(ref), exist_ok=True)
        os.makedirs(os.path.dirname(port), exist_ok=True)
        _write_volume(ref, base_bytes + 17_000 * v + 3 * v, seed + v)
        for ext in (".dat", ".idx"):
            shutil.copyfile(ref + ext, port + ext)
        refs.append(ref)
        ports.append(port)
    return refs, ports


def _read(path: str) -> bytes:
    with open(path, "rb") as f:
        return f.read()


def _assert_same_shards(refs, ports, exts=SHARDS) -> None:
    for r, p in zip(refs, ports):
        for ext in exts:
            assert _read(r + ext) == _read(p + ext), (p, ext)


def _assert_crcs_of_files(bases, crcs) -> None:
    for base, vol in zip(bases, crcs):
        assert vol == [crc32c(_read(base + ext)) for ext in SHARDS]


@pytest.mark.parametrize("shape", [(1, 1), (2, 1), (1, 2)], ids=["1x1", "2x1", "1x2"])
def test_encode_batch_matches_reference(tmp_path, shape):
    ref_codec, port_codec = _codecs(*shape)
    refs, ports = _volumes(tmp_path, 4)
    rs, ps = {}, {}
    ref_files.write_ec_files_batch(
        refs, codec=ref_codec, stats=rs, want_crcs=True, durable=True, **BLOCKS
    )
    ec_files.write_ec_files_batch(
        ports, codec=port_codec, stats=ps, want_crcs=True, durable=True, **BLOCKS
    )
    for r, p in zip(refs, ports):
        ref_files.write_sorted_file_from_idx(r)
        ec_files.write_sorted_file_from_idx(p, durable=True)
    _assert_same_shards(refs, ports, SHARDS + [".ecx"])
    assert ps["shard_crcs"] == rs["shard_crcs"]
    _assert_crcs_of_files(ports, ps["shard_crcs"])
    assert {k: ps[k] for k in STRUCT} == {k: rs[k] for k in STRUCT}
    # stripe 1: every 4 KiB round is the full width and takes the fused
    # CRC; stripe 2 pads the width to 8 KiB, so every round is a tail
    assert (ps["host_crc_rows"] == 0) == (shape[1] == 1)
    assert ps["ring_pinned"] is False and 0 < ps["ring_bytes"]
    span = trace.recent(1)[0]
    assert span["name"] == "ec_stream.encode_batch"
    # the batch arm equals the single-volume driver on every volume
    single = str(tmp_path / "single")
    shutil.copyfile(ports[2] + ".dat", single + ".dat")
    ec_files.write_ec_files(
        single, rs=new_encoder(backend="cuda", device="cpu"), buffer_size=4096, **BLOCKS
    )
    _assert_same_shards([single], [ports[2]])


def test_serial_arm_matches_reference(tmp_path, monkeypatch):
    monkeypatch.setenv("WEED_EC_PIPELINE", "0")
    ref_codec, port_codec = _codecs(2, 1)
    refs, ports = _volumes(tmp_path, 2, seed=5)
    rs, ps = {}, {}
    ref_files.write_ec_files_batch(
        refs, codec=ref_codec, tile_bytes=4096, stats=rs, want_crcs=True, **BLOCKS
    )
    ec_files.write_ec_files_batch(
        ports, codec=port_codec, tile_bytes=4096, stats=ps, want_crcs=True,
        durable=True, **BLOCKS
    )
    _assert_same_shards(refs, ports)
    assert ps["shard_crcs"] == rs["shard_crcs"]
    assert "pipeline_depth" not in ps  # the serial arm ran
    _assert_crcs_of_files(ports, ps["shard_crcs"])


def test_batch_limit_chunks(tmp_path, monkeypatch):
    """WEED_EC_PIPELINE_BATCH=2 splits 3 volumes into chunks of 2 and 1,
    each on a mesh sized to it: over the reference's 8 virtual devices,
    and over the port codec's 8 CPU devices."""
    monkeypatch.setenv("WEED_EC_PIPELINE_BATCH", "2")
    assert ec_stream.pipeline_batch_limit() == 2
    ref_codec, port_codec = _codecs(4, 2)
    refs, ports = _volumes(tmp_path, 3, seed=9, base_bytes=30_000)
    rs, ps = {}, {}
    ref_stream.stream_write_ec_files_batch(
        refs, codec=ref_codec, stats=rs, want_crcs=True, **BLOCKS
    )
    ec_stream.stream_write_ec_files_batch(
        ports, codec=port_codec, stats=ps, want_crcs=True, **BLOCKS
    )
    _assert_same_shards(refs, ports)
    assert ps["shard_crcs"] == rs["shard_crcs"]
    assert len(ps["shard_crcs"]) == 3
    assert {k: ps[k] for k in STRUCT} == {k: rs[k] for k in STRUCT}
    assert ps["mesh"] == {"vol": 1, "stripe": 8}  # the last chunk's


def _damage(refs, ports, lost_of):
    originals = {}
    for v, (r, p) in enumerate(zip(refs, ports)):
        for i in lost_of(v):
            originals[(v, i)] = _read(p + ec_files.to_ext(i))
            os.remove(r + ec_files.to_ext(i))
            os.remove(p + ec_files.to_ext(i))
    return originals


def _lost(v):
    return (3,) if v % 2 else (0, 5, 10, 13)


@pytest.mark.parametrize("limit", ["0", "2"], ids=["whole", "chunked"])
def test_rebuild_batch_two_signatures(tmp_path, monkeypatch, limit):
    monkeypatch.setenv("WEED_EC_PIPELINE_BATCH", limit)
    ref_codec, port_codec = _codecs(2, 4)
    refs, ports = _volumes(tmp_path, 6, seed=20)
    ref_files.write_ec_files_batch(refs, codec=ref_codec, **BLOCKS)
    for r, p in zip(refs, ports):
        for ext in SHARDS:
            shutil.copyfile(r + ext, p + ext)
    originals = _damage(refs, ports, _lost)
    rs, ps = {}, {}
    want = ref_stream.stream_rebuild_ec_files_batch(
        refs, codec=ref_codec, tile_bytes=8192, stats=rs, want_crcs=True
    )
    got = ec_files.rebuild_ec_files_batch(
        ports, codec=port_codec, tile_bytes=8192, stats=ps, want_crcs=True,
        durable=True,
    )
    assert got == want == [list(_lost(v)) for v in range(6)]
    _assert_same_shards(refs, ports)
    for (v, i), blob in originals.items():
        assert _read(ports[v] + ec_files.to_ext(i)) == blob
        assert ps["shard_crcs"][v][i] == crc32c(blob)
    assert ps["shard_crcs"] == rs["shard_crcs"]
    keys = STRUCT + ("batch_groups",)
    assert {k: ps[k] for k in keys} == {k: rs[k] for k in keys}
    assert ps["batch_groups"] == 2 and ps["host_crc_rows"] > 0
    assert trace.recent(1)[0]["name"] == "ec_stream.rebuild_batch"


def test_rebuild_serial_arm_matches(tmp_path, monkeypatch):
    ref_codec, port_codec = _codecs(1, 1)
    refs, ports = _volumes(tmp_path, 2, seed=30)
    ref_files.write_ec_files_batch(refs, codec=ref_codec, **BLOCKS)
    for r, p in zip(refs, ports):
        for ext in SHARDS:
            shutil.copyfile(r + ext, p + ext)
    _damage(refs, ports, _lost)
    monkeypatch.setenv("WEED_EC_PIPELINE", "0")
    rs, ps = {}, {}
    want = ref_files.rebuild_ec_files_batch(refs, stats=rs, want_crcs=True)
    got = ec_files.rebuild_ec_files_batch(
        ports, codec=port_codec, stats=ps, want_crcs=True
    )
    assert got == want
    _assert_same_shards(refs, ports)
    assert ps["shard_crcs"] == rs["shard_crcs"]
    assert ps["batch_volumes"] == rs["batch_volumes"] == 2


def test_empty_volumes_and_nothing_missing(tmp_path):
    _, port_codec = _codecs(1, 1)
    bases = [str(tmp_path / f"e{v}") for v in range(2)]
    for base in bases:
        open(base + ".dat", "wb").close()
    stats = {}
    ec_stream.stream_write_ec_files_batch(
        bases, codec=port_codec, stats=stats, want_crcs=True, durable=True
    )
    for base in bases:
        assert all(os.path.getsize(base + ext) == 0 for ext in SHARDS)
    assert stats["shard_crcs"] == [[0] * 14, [0] * 14]
    st = {}
    assert ec_stream.stream_rebuild_ec_files_batch(
        bases, codec=port_codec, stats=st, want_crcs=True
    ) == [[], []]
    assert st["batch_groups"] == 0 and st["shard_crcs"] == [{}, {}]


def _fds() -> int:
    return len(os.listdir("/proc/self/fd"))


def _enospc_after(monkeypatch, calls: int):
    real = ec_stream._pwritev_full
    seen = [0]

    def failing(fd, bufs, offset):
        seen[0] += 1
        if seen[0] > calls:
            raise OSError(errno.ENOSPC, "No space left on device")
        return real(fd, bufs, offset)

    monkeypatch.setattr(ec_stream, "_pwritev_full", failing)


def test_encode_abort_leaves_no_shards_threads_or_fds(tmp_path, monkeypatch):
    _, port_codec = _codecs(2, 1)
    _, ports = _volumes(tmp_path, 4, seed=40)
    threads, fds = threading.active_count(), _fds()
    _enospc_after(monkeypatch, 30)
    with pytest.raises(OSError) as err:
        ec_files.write_ec_files_batch(ports, codec=port_codec, want_crcs=True, **BLOCKS)
    assert err.value.errno == errno.ENOSPC
    for p in ports:
        assert not any(os.path.exists(p + ext) for ext in SHARDS), p
    assert threading.active_count() == threads and _fds() == fds


def test_rebuild_abort_removes_every_target(tmp_path, monkeypatch):
    ref_codec, port_codec = _codecs(2, 1)
    refs, ports = _volumes(tmp_path, 4, seed=50)
    ref_files.write_ec_files_batch(refs, codec=ref_codec, **BLOCKS)
    for r, p in zip(refs, ports):
        for ext in SHARDS:
            shutil.copyfile(r + ext, p + ext)
    _damage(refs, ports, lambda v: (1, 12))
    threads, fds = threading.active_count(), _fds()
    _enospc_after(monkeypatch, 3)
    with pytest.raises(OSError):
        ec_files.rebuild_ec_files_batch(ports, codec=port_codec, tile_bytes=4096)
    for p in ports:
        assert not os.path.exists(p + ec_files.to_ext(1))
        assert not os.path.exists(p + ec_files.to_ext(12))
        assert os.path.exists(p + ec_files.to_ext(0))  # survivors untouched
    assert threading.active_count() == threads and _fds() == fds


@pytest.mark.parametrize("pipeline", ["1", "0"])
def test_codec_none_needs_a_card(tmp_path, monkeypatch, pipeline):
    # no card and no host codec asked for (WEED_EC_CODEC=native or cpu
    # would ask for the host arm)
    monkeypatch.delenv("WEED_EC_CODEC", raising=False)
    monkeypatch.setenv("WEED_EC_PIPELINE", pipeline)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    _, ports = _volumes(tmp_path, 2, seed=60, base_bytes=20_000)
    with pytest.raises(RuntimeError):
        ec_files.write_ec_files_batch(ports, **BLOCKS)
    assert not any(os.path.exists(p + ext) for p in ports for ext in SHARDS)
    for p in ports:  # a damaged set for the rebuild
        for i in range(10):
            open(p + ec_files.to_ext(i), "wb").close()
    with pytest.raises(RuntimeError):
        ec_files.rebuild_ec_files_batch(ports)
