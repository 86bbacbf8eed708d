"""The port's MeshCodec against seaweedfs_tpu's, on the CPU.

The same seeded numpy batches go through the reference MeshCodec on the
virtual CPU devices tests/conftest.py provides — once with its SWAR
kernels K2/K3 run by the Pallas interpreter (`_swar_interpret`), once
on its default tier — and through the port's MeshCodec on meshes of
torch.device("cpu") at 1x1, 2x2 and 1x4, where the kernels run their
plain versions. Tolerance 0: every result is integer GF(2^8) / GF(2)
math and must be equal bit for bit.
"""

import ast
import pathlib

import jax
import numpy as np
import pytest
import torch

from seaweedfs_tpu.ec.codec import new_encoder as ref_encoder
from seaweedfs_tpu.parallel import MeshCodec as RefMeshCodec
from seaweedfs_tpu.parallel import make_mesh as ref_make_mesh
from seaweedfs_tpu_torch.ec import codec_cuda
from seaweedfs_tpu_torch.parallel import MeshCodec, make_mesh
from seaweedfs_tpu_torch.util.crc import crc32c

B, N32 = 4, 4096  # per device: 1024-4096 lanes on the meshes below
LOST1 = (3,)
LOST4 = (0, 5, 11, 13)
PORT_MESHES = {"1x1": (1, 1), "2x2": (2, 2), "1x4": (1, 4)}
REPO = pathlib.Path(__file__).resolve().parent.parent


def _survivors(lost):
    return tuple(i for i in range(14) if i not in lost)[:10]


def _inputs():
    rng = np.random.default_rng(2024)
    data = rng.integers(0, 2**32, (B, 10, N32), dtype=np.uint32)
    rs = ref_encoder(backend="cpu")
    parity = np.stack([rs._apply(rs.parity_rows, v.view(np.uint8)) for v in data])
    return data, parity.view(np.uint32)


DATA, PARITY = _inputs()
ALL = np.concatenate([DATA, PARITY], axis=1)  # [B, 14, N32]


def _planted():
    """Parity with (a) one byte flipped in volume 1, (b) two bytes of
    ONE lane flipped in volume 2 (1 lane, 2 bytes), (c) three lanes of
    two rows flipped in volume 3; volume 0 stays good."""
    bad = PARITY.copy()
    b8 = bad.view(np.uint8)
    b8[1, 0, 4 * 100 + 2] ^= 0x40
    b8[2, 3, 4 * 2000] ^= 0x01
    b8[2, 3, 4 * 2000 + 3] ^= 0x80
    bad[3, 1, 7] ^= 0xFFFFFFFF
    bad[3, 1, 4000] ^= 0x10
    bad[3, 2, 7] ^= 0x1
    return bad


BAD = _planted()


@pytest.fixture(scope="module", params=["interpret", "default"])
def ref(request):
    """The reference's results on a 2x2 mesh of virtual CPU devices,
    computed once per tier."""
    devs = jax.devices()
    if len(devs) < 4:
        pytest.skip("needs the conftest's virtual CPU devices")
    codec = RefMeshCodec(ref_make_mesh(devs[:4], stripe=2))
    codec._swar_interpret = request.param == "interpret"
    sv = codec.shard_volumes
    parity, crcs = codec.encode_batch_u32_crc(sv(DATA))
    out = {
        "codec": codec,
        "encode": np.asarray(codec.encode_batch_u32(sv(DATA))),
        "crc_parity": np.asarray(parity),
        "crcs": np.asarray(crcs),
        "verify_good": np.asarray(codec.verify_batch_u32(sv(DATA), sv(PARITY))),
        "verify_bad": np.asarray(codec.verify_batch_u32(sv(DATA), sv(BAD))),
        "verify_bytes": np.asarray(
            codec.verify_batch(sv(DATA.view(np.uint8)), sv(BAD.view(np.uint8)))
        ),
    }
    for lost in (LOST1, LOST4):
        surv = _survivors(lost)
        out[lost] = np.asarray(
            codec.reconstruct_batch_u32(surv, lost, sv(ALL[:, list(surv)]))
        )
    return out


@pytest.fixture(params=sorted(PORT_MESHES))
def port(request, ref):
    vol, stripe = PORT_MESHES[request.param]
    return MeshCodec(
        make_mesh(["cpu"] * (vol * stripe), stripe=stripe),
        matrix=ref["codec"].matrix,
    )


def test_encode_batch_u32(ref, port):
    got = np.asarray(port.encode_batch_u32(port.shard_volumes(DATA)))
    np.testing.assert_array_equal(got.view(np.uint32), ref["encode"])
    np.testing.assert_array_equal(got.view(np.uint32), PARITY)


def test_encode_batch_u32_crc(ref, port):
    vols = port.shard_volumes(DATA, parity_room=True)
    parity, crcs = port.encode_batch_u32_crc(vols)
    crcs = np.asarray(crcs).view(np.uint32)
    np.testing.assert_array_equal(np.asarray(parity).view(np.uint32), ref["crc_parity"])
    np.testing.assert_array_equal(crcs, ref["crcs"])
    for v in range(B):
        assert [crc32c(ALL[v, i]) for i in range(14)] == crcs[v].tolist()
    # the parity was written into the blocks' own tiles, contiguous
    for prow, trow in zip(parity.blocks, vols.tiles):
        for blk, tile in zip(prow, trow):
            assert blk.is_contiguous() and blk.data_ptr() > tile.data_ptr()
            assert blk.data_ptr() < tile.data_ptr() + tile.numel() * 4
    # blocks without parity room take a copy into a fresh tile: same result
    _, again = port.encode_batch_u32_crc(port.shard_volumes(DATA))
    np.testing.assert_array_equal(np.asarray(again).view(np.uint32), crcs)


@pytest.mark.parametrize("lost", [LOST1, LOST4], ids=["lost1", "lost4"])
def test_reconstruct_batch_u32(ref, port, lost):
    surv = _survivors(lost)
    got = np.asarray(
        port.reconstruct_batch_u32(surv, lost, port.shard_volumes(ALL[:, list(surv)]))
    ).view(np.uint32)
    np.testing.assert_array_equal(got, ref[lost])
    np.testing.assert_array_equal(got, ALL[:, list(lost)])


def test_verify_batch_u32_counts_lanes(ref, port):
    sv = port.shard_volumes
    good = np.asarray(port.verify_batch_u32(sv(DATA), sv(PARITY)))
    np.testing.assert_array_equal(good, ref["verify_good"])
    assert good.tolist() == [0] * B
    bad = np.asarray(port.verify_batch_u32(sv(DATA), sv(BAD)))
    np.testing.assert_array_equal(bad, ref["verify_bad"])
    # one byte; two bytes of one lane; three (row, lane) pairs
    assert bad.tolist() == [0, 1, 1, 3]


def test_verify_batch_counts_bytes(ref, port):
    sv = port.shard_volumes
    got = np.asarray(port.verify_batch(sv(DATA.view(np.uint8)), sv(BAD.view(np.uint8))))
    np.testing.assert_array_equal(got, ref["verify_bytes"])
    # the two-byte flip in one lane counts 2 here and 1 in verify_batch_u32
    assert got[2] == 2 and got[0] == 0
    good = np.asarray(
        port.verify_batch(sv(DATA.view(np.uint8)), sv(PARITY.view(np.uint8)))
    )
    assert good.tolist() == [0] * B


def test_byte_layout_encode_and_reconstruct(ref, port):
    """The byte APIs (K2 on byte<->lane views), ragged byte widths too."""
    d8, a8 = DATA.view(np.uint8), ALL.view(np.uint8)
    got = np.asarray(port.encode_batch(port.shard_volumes(d8)))
    np.testing.assert_array_equal(got, ref["encode"].view(np.uint8))
    surv = _survivors(LOST4)
    rebuilt = np.asarray(
        port.reconstruct_batch(surv, LOST4, port.shard_volumes(a8[:, list(surv)]))
    )
    np.testing.assert_array_equal(rebuilt, a8[:, list(LOST4)])
    stripe = port.mesh.shape["stripe"]
    ragged = d8[:, :, : 4 * 37 * stripe + 2 * stripe]  # not whole lanes per device
    got = np.asarray(port.encode_batch(port.shard_volumes(ragged)))
    rs = ref_encoder(backend="cpu")
    for v in range(B):
        np.testing.assert_array_equal(got[v], rs._apply(rs.parity_rows, ragged[v]))


def test_layout_contracts_match_reference():
    devs = jax.devices()
    for vol, stripe in ((2, 2), (1, 4), (4, 2), (1, 1)):
        r = RefMeshCodec(ref_make_mesh(devs[: vol * stripe], stripe=stripe))
        p = MeshCodec(make_mesh(["cpu"] * (vol * stripe), stripe=stripe))
        assert p.mesh.devices.shape == r.mesh.devices.shape == (vol, stripe)
        assert p.mesh.shape == dict(r.mesh.shape)
        for n_bytes in (4, 1024, 4096 + 8, 32 * 1024, 3 * 4096, 1 << 20, 12, 6):
            assert p.crc_supported(n_bytes) == r.crc_supported(n_bytes), (vol, stripe, n_bytes)
            for batch in (1, 2, 4, 8):
                try:
                    want = r.batch_layout(batch, n_bytes)
                except ValueError:
                    with pytest.raises(ValueError):
                        p.batch_layout(batch, n_bytes)
                    continue
                assert p.batch_layout(batch, n_bytes) == want


def test_make_mesh_shapes_and_no_card(monkeypatch):
    assert make_mesh(["cpu"] * 8).devices.shape == (4, 2)
    assert make_mesh(["cpu"] * 8, stripe=1).devices.shape == (8, 1)
    assert make_mesh(["cpu"] * 3).devices.shape == (3, 1)
    with pytest.raises(ValueError):
        make_mesh(["cpu"] * 8, stripe=3)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError):
        make_mesh()
    with pytest.raises(RuntimeError):
        MeshCodec(make_mesh([torch.device("cuda", 0)]))


def test_shard_volumes_checks_and_launch_counts():
    codec = MeshCodec(make_mesh(["cpu"] * 4, stripe=2))
    with pytest.raises(ValueError):
        codec.shard_volumes(DATA[:3])  # 3 volumes over a 2-way vol axis
    with pytest.raises(ValueError):
        codec.shard_volumes(DATA[:, :, :4095])
    sharded = codec.shard_volumes(DATA)
    assert sharded.shape == (B, 10, N32)
    assert [[blk.shape for blk in row] for row in sharded.blocks] == [
        [(2, 10, N32 // 2)] * 2
    ] * 2
    before = (
        codec_cuda.BATCH_LAUNCHES.value, codec_cuda.VERIFY_LAUNCHES.value,
    )
    codec.encode_batch_u32(sharded)
    codec.verify_batch_u32(sharded, codec.shard_volumes(PARITY))
    # plain versions on the CPU are not launches
    assert (codec_cuda.BATCH_LAUNCHES.value, codec_cuda.VERIFY_LAUNCHES.value) == before


def _imports(path: pathlib.Path) -> set[str]:
    names = set()
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            names.update(alias.name for alias in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module and not node.level:
            names.add(node.module)
    return names


# the volume server's, the master tier's, the admin plane's, the command
# line's, the serving edge's, the filer core's and the S3 gateway's
# slices: every module they added is walked too
SERVER_SLICE = (
    "pb/rpc.py", "pb/volume_pb2.py", "pb/master_pb2.py", "pb/filer_pb2.py",
    "pb/raft_pb2.py", "pb/tikv_pb2.py", "util/deadline.py", "util/http_range.py",
    "util/compression.py", "util/multipart.py", "util/status_ui.py", "util/httpd.py",
    "trace/blackbox.py", "security/jwt.py", "security/guard.py", "security/tls.py",
    "qos/admission.py", "qos/group_commit.py", "scrub/arbiter.py", "cluster/health.py",
    "server/write_path.py", "server/volume_server.py",
    "telemetry/profiler.py", "images/__init__.py",
    # the master tier's slice
    "stats/duration_counter.py", "stats/__init__.py", "sequence.py",
    "topology/__init__.py", "topology/node.py", "topology/volume_layout.py",
    "topology/volume_growth.py", "topology/topology.py", "cluster/__init__.py",
    "cluster/raft.py", "server/master_server.py", "stats/metrics.py",
    "util/availability.py", "client/__init__.py", "client/operation.py",
    "client/retry.py",
    # the admin plane's slice
    "client/vid_map.py", "client/masterclient.py", "shell/__init__.py",
    "shell/command_env.py", "shell/ec_common.py", "shell/commands.py",
    "shell/shell_runner.py",
    # the command line and the integrity plane's slice
    "__main__.py", "command/__init__.py", "command/servers.py", "command/tools.py",
    "command/benchmark.py", "command/filer_tools.py", "util/config.py",
    "util/profiling.py", "scrub/__init__.py", "scrub/ratelimit.py", "scrub/state.py",
    "scrub/verify.py", "scrub/engine.py", "scrub/repair.py", "tier/__init__.py",
    "tier/rules.py", "tier/ec_tier.py", "tier/scheduler.py",
    # the serving edge's slice
    "native/ext.py", "util/native_serve.py", "server/volume_workers.py",
    "storage/needle.py", "storage/volume.py", "analysis/__init__.py",
    "analysis/fuzz_serve.py",
    # the filer core's slice
    "util/etcd.py", "filer/__init__.py", "filer/entry.py", "filer/filechunks.py",
    "filer/filerstore.py", "filer/lsm.py", "filer/abstract_sql.py", "filer/mysql_driver.py",
    "filer/pg_driver.py", "filer/redis_store.py", "filer/cassandra_store.py",
    "filer/etcd_store.py", "filer/tikv_store.py", "filer/filer.py", "filer/stream.py",
    "notification/__init__.py", "server/filer_server.py", "shell/fs_commands.py",
    # the S3 gateway's slice
    "s3api/__init__.py", "s3api/errors.py", "s3api/auth.py", "s3api/chunked_reader.py",
    "s3api/client.py", "s3api/s3api_server.py",
    # WebDAV, the query engine and the s3 tier backend's slice
    "webdav/__init__.py", "webdav/webdav_server.py", "query/__init__.py",
    "query/json_query.py", "storage/backend_s3.py",
    # the logqueue and replication's slice
    "notification/logqueue.py", "replication/__init__.py", "replication/source.py",
    "replication/sink.py", "replication/replicator.py", "replication/replicate_runner.py",
)


def test_port_imports_neither_jax_nor_the_reference():
    files = sorted((REPO / "seaweedfs_tpu_torch").rglob("*.py")) + [REPO / "chip_smoke.py"]
    assert len(files) > 20
    walked = {p.relative_to(REPO / "seaweedfs_tpu_torch").as_posix() for p in files[:-1]}
    assert set(SERVER_SLICE) <= walked, set(SERVER_SLICE) - walked
    for path in files:
        for name in _imports(path):
            top = name.split(".")[0]
            assert top not in ("jax", "jaxlib", "seaweedfs_tpu"), (path, name)
