"""The port's "native" host codec (csrc/gf256.c through native/gf.py and
ec/codec_native.py) against seaweedfs_tpu's, on the CPU.

The shim is a copy of the reference's: the same matrix over the same
inputs must give the same bytes from the port's shim, the reference's
shim and the port's numpy "cpu" codec, over random matrices (r and k
1..16) and odd lengths, 0 and 1 included. Tolerance: byte identity
everywhere. A `native` ReedSolomon encodes and rebuilds shard files
through the pipelined driver, byte-identical to the reference's native
codec and to the port's cuda backend (its plain versions, device="cpu").
Nothing picks `native` unless it is named, and a shim that cannot be
built raises.
"""

import filecmp
import os
import shutil
import threading

import numpy as np
import pytest

from seaweedfs_tpu.ec import ec_files as ref_files
from seaweedfs_tpu.ec.codec import new_encoder as ref_encoder
from seaweedfs_tpu.native import gf as ref_gf
from seaweedfs_tpu_torch import _build
from seaweedfs_tpu_torch.ec import codec, ec_files
from seaweedfs_tpu_torch.ec.codec import cpu_apply_matrix, new_encoder
from seaweedfs_tpu_torch.native import gf
from tests.test_torch_ec_files import SHARDS, _write_volume

LENGTHS = (0, 1, 2, 15, 31, 33, 64, 1023, 4097, 65537)


@pytest.mark.parametrize("r", range(1, 17))
def test_apply_matrix_matches_reference_and_cpu(r):
    rng = np.random.default_rng(r)
    for k in range(1, 17):
        for n in LENGTHS[k % 3 :: 3]:
            m = rng.integers(0, 256, (r, k), dtype=np.uint8)
            m[rng.random((r, k)) < 0.2] = 0  # zero and one coefficients take
            m[rng.random((r, k)) < 0.1] = 1  # their own branches in the shim
            x = rng.integers(0, 256, (k, n), dtype=np.uint8)
            got = gf.apply_matrix(m, x)
            assert got.shape == (r, n)
            np.testing.assert_array_equal(got, ref_gf.apply_matrix(m, x))
            np.testing.assert_array_equal(got, cpu_apply_matrix(m, x))


def test_apply_matrix_rejects_a_shape_mismatch():
    with pytest.raises(ValueError):
        gf.apply_matrix(np.ones((2, 3), np.uint8), np.ones((4, 8), np.uint8))


def test_caps_names_a_path():
    assert gf.caps() in gf.CAPS_NAMES.values()


def test_threads_share_the_shim():
    """ctypes releases the GIL for the call: threads run it at once."""
    rng = np.random.default_rng(3)
    m = rng.integers(0, 256, (4, 10), dtype=np.uint8)
    xs = [rng.integers(0, 256, (10, 200_001), dtype=np.uint8) for _ in range(8)]
    want = [cpu_apply_matrix(m, x) for x in xs]
    got = [None] * len(xs)

    def run(i):
        got[i] = gf.apply_matrix(m, xs[i])

    threads = [threading.Thread(target=run, args=(i,)) for i in range(len(xs))]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("lost", [(0,), (3, 11), (0, 5, 10, 13), (10, 11, 12, 13)])
def test_rs_10_4_encode_and_reconstruct(lost):
    rng = np.random.default_rng(len(lost))
    data = [rng.integers(0, 256, 10_007, dtype=np.uint8) for _ in range(10)]
    nat, cpu, ref = new_encoder(backend="native"), new_encoder(backend="cpu"), ref_encoder(
        backend="native"
    )
    shards = nat.encode(list(data) + [None] * 4)
    want = cpu.encode(list(data) + [None] * 4)
    for a, b, c in zip(shards, want, ref.encode(list(data) + [None] * 4)):
        np.testing.assert_array_equal(a, b)
        np.testing.assert_array_equal(a, c)
    assert nat.verify(shards)
    damaged = [None if i in lost else s for i, s in enumerate(shards)]
    for a, b in zip(nat.reconstruct(list(damaged)), shards):
        np.testing.assert_array_equal(a, b)
    data_only = nat.reconstruct_data(list(damaged))
    for i in range(10):
        np.testing.assert_array_equal(data_only[i], shards[i])


def test_native_is_accepted_and_never_the_default(monkeypatch):
    monkeypatch.delenv("WEED_EC_CODEC", raising=False)
    assert codec.default_backend() == "cuda"
    monkeypatch.setenv("WEED_EC_CODEC", "native")
    assert codec.default_backend() == "native"
    assert new_encoder()._backend_name == "native"
    monkeypatch.setenv("WEED_EC_CODEC", "cpu")
    assert new_encoder()._backend_name == "cpu"


def _fresh_build(monkeypatch, tmp_path):
    """A build state with nothing built or loaded yet."""
    monkeypatch.setattr(_build, "BUILD_DIR", str(tmp_path / "build"))
    monkeypatch.setattr(_build, "_libs", {})
    monkeypatch.setattr(gf, "_lib", None)


def test_no_compiler_raises(monkeypatch, tmp_path):
    _fresh_build(monkeypatch, tmp_path)
    monkeypatch.setenv("PATH", str(tmp_path / "empty"))
    with pytest.raises(RuntimeError, match="no C compiler"):
        gf.apply_matrix(np.ones((1, 1), np.uint8), np.ones((1, 4), np.uint8))
    with pytest.raises(RuntimeError, match="no C compiler"):
        new_encoder(backend="native")


def test_a_failed_compile_raises_with_the_compiler_output(monkeypatch, tmp_path):
    csrc = tmp_path / "csrc"
    csrc.mkdir()
    (csrc / "gf256.c").write_text("int broken(void) { return undeclared_name; }\n")
    _fresh_build(monkeypatch, tmp_path)
    monkeypatch.setattr(_build, "CSRC", str(csrc))
    with pytest.raises(RuntimeError, match="undeclared_name"):
        gf.load()
    assert not os.listdir(tmp_path / "build") or all(
        not name.endswith(".so") for name in os.listdir(tmp_path / "build")
    )


# --- the CPython extensions (needle codec, serving core) -----------------------


def _fresh_ext_build(monkeypatch, tmp_path):
    """An extension build state with nothing built or loaded yet."""
    monkeypatch.setattr(_build, "BUILD_DIR", str(tmp_path / "build"))
    monkeypatch.setattr(_build, "_exts", {})


def _csrc_copy(tmp_path):
    csrc = tmp_path / "csrc"
    shutil.copytree(_build.CSRC, csrc)
    return csrc


def test_extension_build_with_a_missing_compiler_raises(monkeypatch, tmp_path):
    """No quiet pure-Python fallback: with no compiler to be found the
    first use of either extension raises, naming what it tried."""
    from seaweedfs_tpu_torch.native import ext
    from seaweedfs_tpu_torch.storage.needle import Needle

    _fresh_ext_build(monkeypatch, tmp_path)
    monkeypatch.setattr(_build, "COMPILERS", ("no-such-cc-for-the-test",))
    for load in (ext.needle_ext, ext.serve_ext):
        with pytest.raises(RuntimeError, match="no C compiler found .*no-such-cc-for-the-test"):
            load()
    with pytest.raises(RuntimeError, match="no C compiler"):
        Needle(cookie=1, id=2, data=b"x").encode_record()


def test_extension_failed_compile_raises_with_the_compiler_output(monkeypatch, tmp_path):
    """A compile error in a file the extension only includes (post.c,
    under needle_ext.c) is raised with the compiler's message."""
    from seaweedfs_tpu_torch.native import ext

    csrc = _csrc_copy(tmp_path)
    with open(csrc / "post.c", "a") as f:
        f.write("\nint planted_break(void) { return undeclared_planted_name; }\n")
    _fresh_ext_build(monkeypatch, tmp_path)
    monkeypatch.setattr(_build, "CSRC", str(csrc))
    with pytest.raises(RuntimeError, match="undeclared_planted_name"):
        ext.needle_ext()
    assert not any(n.endswith(".so") for n in os.listdir(tmp_path / "build"))


@pytest.mark.parametrize("edited", ["needle_ext.c", "needle.c", "post.c", "crc32c.c"])
def test_extension_digest_covers_the_include_graph(monkeypatch, tmp_path, edited):
    """An edit to any file that needle_ext.c reaches through #include
    (needle.c, post.c, and crc32c.c through needle.c) names a new
    artifact, so a stale library is never served; serve_ext's does not
    move."""
    csrc = _csrc_copy(tmp_path)
    monkeypatch.setattr(_build, "CSRC", str(csrc))
    before = {src: _build._command(src)[1] for src in _build.EXT_MODULES}
    with open(csrc / edited, "a") as f:
        f.write("\n/* edited */\n")
    after = {src: _build._command(src)[1] for src in _build.EXT_MODULES}
    assert after["needle_ext.c"] != before["needle_ext.c"]
    assert after["serve_ext.c"] == before["serve_ext.c"]


# --- shard files through the pipelined driver ---------------------------------

BLOCKS = dict(large_block_size=1 << 20, small_block_size=16384)


def _pair(tmp_path, nbytes: int, seed: int):
    ref = str(tmp_path / "ref" / "1")
    port = str(tmp_path / "port" / "1")
    os.makedirs(os.path.dirname(ref))
    os.makedirs(os.path.dirname(port))
    _write_volume(ref, nbytes, seed)
    for ext in (".dat", ".idx"):
        shutil.copyfile(ref + ext, port + ext)
    return ref, port


def _same(a: str, b: str, exts) -> None:
    for ext in exts:
        assert filecmp.cmp(a + ext, b + ext, shallow=False), ext


@pytest.mark.parametrize("pipeline", ["1", "0"], ids=["pipelined", "classic"])
def test_encode_and_rebuild_files_match(tmp_path, monkeypatch, pipeline):
    monkeypatch.setenv("WEED_EC_PIPELINE", pipeline)
    ref, port = _pair(tmp_path, 700_000, 41)
    rs_ref, st = {}, {}
    ref_files.write_ec_files(ref, rs=ref_encoder(backend="native"), buffer_size=16384,
                             want_crcs=True, stats=rs_ref, **BLOCKS)
    ec_files.write_ec_files(port, rs=new_encoder(backend="native"), buffer_size=16384,
                            want_crcs=True, durable=True, stats=st, **BLOCKS)
    _same(ref, port, SHARDS)
    assert st["shard_crcs"] == rs_ref["shard_crcs"]
    # the pipelined driver ran (its stage pair in the writer pool), or
    # the classic loop when the pipeline is switched off
    assert ("pipeline_depth" in st) == (pipeline == "1")
    # and the port's cuda backend (plain versions) writes the same bytes
    cuda = str(tmp_path / "cuda" / "1")
    os.makedirs(os.path.dirname(cuda))
    shutil.copyfile(port + ".dat", cuda + ".dat")
    ec_files.write_ec_files(cuda, rs=new_encoder(backend="cuda", device="cpu"),
                            buffer_size=16384, **BLOCKS)
    _same(port, cuda, SHARDS)

    lost = (0, 5, 10, 13)
    originals = {i: open(port + ec_files.to_ext(i), "rb").read() for i in lost}
    for base in (ref, port):
        for i in lost:
            os.remove(base + ec_files.to_ext(i))
    rr, rp = {}, {}
    want = ref_files.rebuild_ec_files(ref, rs=ref_encoder(backend="native"),
                                      buffer_size=16384, want_crcs=True, stats=rr)
    got = ec_files.rebuild_ec_files(port, rs=new_encoder(backend="native"),
                                    buffer_size=16384, want_crcs=True, durable=True,
                                    stats=rp)
    assert list(got) == list(want) == list(lost)
    _same(ref, port, SHARDS)
    for i in lost:
        assert open(port + ec_files.to_ext(i), "rb").read() == originals[i]
        assert rp["shard_crcs"][i] == st["shard_crcs"][i]
    assert ("pipeline_depth" in rp) == (pipeline == "1")
