"""The port's CUDA kernels against their plain versions, on the card.

Marked `cuda`: every test takes the `card` fixture, which skips when
there is no CUDA device or no nvcc (decided inside the fixture, never
at import). Run on a machine with an H100:

    python -m pytest tests/test_torch_cuda.py -m cuda

Tolerance 0 throughout (integer GF(2^8) / GF(2) math).
"""

import os

import numpy as np
import pytest
import torch

from seaweedfs_tpu_torch import _build
from seaweedfs_tpu_torch.ec import codec_cuda, crc_kernel, ec_files, gf256
from seaweedfs_tpu_torch.ec.codec import new_encoder
from seaweedfs_tpu_torch.util.crc import crc32c

pytestmark = pytest.mark.cuda

MATRIX = gf256.build_code_matrix(10, 14)
LOST4 = (0, 5, 10, 13)
SURV4 = tuple(i for i in range(14) if i not in LOST4)
LANES = 262144  # 1 MiB of stream per row


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    try:
        _build._nvcc()
    except RuntimeError:
        pytest.skip("needs nvcc to build the kernels")
    return torch.device("cuda")


def _lanes(shape, seed, device):
    g = torch.Generator(device=device).manual_seed(seed)
    return torch.randint(
        -(2**31), 2**31 - 1, shape, dtype=torch.int32, device=device, generator=g
    )


@pytest.mark.parametrize(
    "rows",
    [MATRIX[10:], gf256.decode_rows(MATRIX, SURV4, LOST4),
     gf256.decode_rows(MATRIX, tuple(range(1, 11)), (0,))],
    ids=["encode", "decode4", "decode1"],
)
def test_k1_equals_plain_at_tile_width(card, rows):
    x = _lanes((10, LANES), 1, card)
    before = codec_cuda.LAUNCHES.value
    got = codec_cuda.gf_apply_u32(rows, x)
    torch.cuda.synchronize()
    assert codec_cuda.LAUNCHES.value == before + 1
    assert torch.equal(got, codec_cuda.gf_apply_plain(rows, x))


@pytest.mark.parametrize("n32", [65536, 131072])
def test_piggyback_shapes_equal_plain_and_tally_signatures(card, n32):
    """The piggybacked and parity rebuilds' shapes: K1 with the 2-row
    decode matrices of (0, 5) and (10, 13), K4 over their 2-row tiles.
    Each launch is tallied under its signature, on this thread too."""
    rows05 = gf256.decode_rows(MATRIX, SURV4, (0, 5))
    rows1013 = gf256.decode_rows(MATRIX, tuple(range(10)), (10, 13))
    x = _lanes((10, n32), n32, card)
    k1, k4 = codec_cuda.LAUNCHES.by_signature(), crc_kernel.LAUNCHES.by_signature()
    mine = codec_cuda.LAUNCHES.mine()[0]
    for rows in (rows05, rows1013):
        got = codec_cuda.gf_apply_u32(rows, x)
        assert torch.equal(got, codec_cuda.gf_apply_plain(rows, x))
        assert torch.equal(crc_kernel.crc32c_rows(got), crc_kernel.crc32c_rows_plain(got))
        sig = (2, 10, n32, np.asarray(rows, dtype=np.uint8).tobytes())
        assert codec_cuda.LAUNCHES.by_signature()[sig] == k1.get(sig, 0) + 1
    assert crc_kernel.LAUNCHES.by_signature()[(2, n32)] == k4.get((2, n32), 0) + 2
    assert codec_cuda.LAUNCHES.mine()[0] == mine + 2


@pytest.mark.parametrize("n32", [1, 3, 1001, 4097])
def test_k1_ragged_and_unaligned(card, n32):
    base = _lanes((10 * n32 + 1,), n32, card)
    x = base[1:].view(10, n32)  # 4-byte aligned only: the scalar variant
    got = codec_cuda.gf_apply_u32(MATRIX[10:], x)
    assert torch.equal(got, codec_cuda.gf_apply_plain(MATRIX[10:], x))


def _random_rows(r, k, seed):
    """Random GF rows with zero coefficients and a first row whose top
    bit is below 7 (the Horner chain then starts lower)."""
    rng = np.random.default_rng(seed)
    rows = rng.integers(0, 256, (r, k), dtype=np.uint8)
    rows[rng.random((r, k)) < 0.25] = 0
    rows[0] &= 0x3F
    return rows


@pytest.mark.parametrize("r", [1, 4, 16])
@pytest.mark.parametrize("k", range(1, 17))
def test_k1_k2_every_width(card, k, r):
    """K1 and K2 at every column count (one kernel instantiation each)
    against the plain versions: vector rows, scalar rows one lane off
    with a ragged lane count, and a batch with a volume stride."""
    rows = _random_rows(r, k, 100 * k + r)
    x = _lanes((k, 4096), k, card)
    assert torch.equal(codec_cuda.gf_apply_u32(rows, x), codec_cuda.gf_apply_plain(rows, x))
    n32 = 1001
    xs = _lanes((k * n32 + 1,), k + 1, card)[1:].view(k, n32)
    assert torch.equal(codec_cuda.gf_apply_u32(rows, xs), codec_cuda.gf_apply_plain(rows, xs))
    for pad, n in ((4, 2048), (1, n32)):  # vector and scalar batch rows
        xb = _lanes((3, k * n + pad), k + pad, card)[:, : k * n].view(3, k, n)
        got = codec_cuda.gf_apply_u32_batch(rows, xb)
        assert torch.equal(got, codec_cuda.gf_apply_batch_plain(rows, xb))


@pytest.mark.parametrize("rows", [1, 4, 14, 224])
def test_k4_equals_plain_at_tile_width(card, rows):
    """K4 at the row counts the paths launch it with (1- and 4-shard
    rebuild, single-volume encode, batch encode round): one launch,
    equal to the plain version, the host CRC and the raw form."""
    x = _lanes((rows, LANES), 2 + rows, card)
    before = crc_kernel.LAUNCHES.value
    got = crc_kernel.crc32c_rows(x)
    torch.cuda.synchronize()
    assert crc_kernel.LAUNCHES.value == before + 1
    assert torch.equal(got, crc_kernel.crc32c_rows_plain(x))
    host = x.cpu().numpy()
    assert got.cpu().numpy().view(np.uint32).tolist() == [crc32c(host[i]) for i in range(rows)]
    lin = crc_kernel.crc_lin_rows(x)
    assert torch.equal(crc_kernel.finalize_rows(lin, 4 * LANES), got)


def test_k4_back_to_back_launches_reset_their_tickets(card):
    """100 launches on one stream, no synchronisation between them: each
    row's last block sets its ticket back to 0 for the next launch."""
    xs = _lanes((100, 14, 8192), 21, card)
    got = [crc_kernel.crc32c_rows(xs[i]) for i in range(100)]
    torch.cuda.synchronize()
    for i in range(100):
        assert torch.equal(got[i], crc_kernel.crc32c_rows_plain(xs[i])), i


def test_k4_two_streams_at_once(card):
    """Launches on two streams in flight together, on different tiles:
    each stream has its own tickets."""
    xs = _lanes((2, 8, 14, 65536), 22, card)
    streams = [torch.cuda.Stream(), torch.cuda.Stream()]
    for s in streams:
        s.wait_stream(torch.cuda.current_stream())
    got = [[], []]
    for i in range(8):
        for j, s in enumerate(streams):
            with torch.cuda.stream(s):
                got[j].append(crc_kernel.crc32c_rows(xs[j, i]))
    torch.cuda.synchronize()
    for j in range(2):
        for i in range(8):
            assert torch.equal(got[j][i], crc_kernel.crc32c_rows_plain(xs[j, i])), (j, i)


def test_k4_graph_replays(card):
    """16 launches captured in one CUDA graph and replayed twice, the
    inputs rewritten between the replays: byte-exact both times."""
    xs = _lanes((16, 4, 65536), 23, card)
    stream = torch.cuda.Stream()
    stream.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(stream):  # the stream's first call, outside the capture
        crc_kernel.crc32c_rows(xs[0])
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    before = crc_kernel.LAUNCHES.value
    with torch.cuda.graph(graph, stream=stream):
        outs = [crc_kernel.crc32c_rows(xs[i]) for i in range(16)]
    assert crc_kernel.LAUNCHES.value == before + 16
    for seed in (24, 25):
        xs.copy_(_lanes(xs.shape, seed, card))
        graph.replay()
        torch.cuda.synchronize()
        for i in range(16):
            assert torch.equal(outs[i], crc_kernel.crc32c_rows_plain(xs[i])), (seed, i)


def test_k4_graphs_on_two_streams_beside_an_uncaptured_launch(card):
    """Two graphs of 8 K4 launches each, both captured on one stream,
    replayed at once on two other streams while 8 uncaptured K4 calls
    run on the capture stream, four rounds with the inputs rewritten:
    each graph owns the ticket counters it captured, so no two launches
    in flight share them and every result equals the plain version."""
    xs = _lanes((3, 8, 14, 65536), 26, card)
    crc_kernel.crc32c_rows(xs[0, 0])  # the geometry's tables, outside any capture
    cap = torch.cuda.Stream()
    cap.wait_stream(torch.cuda.current_stream())
    graphs, outs = [], []
    for g in range(2):
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph, stream=cap):
            outs.append([crc_kernel.crc32c_rows(xs[g, i]) for i in range(8)])
        graphs.append(graph)
    replay_streams = [torch.cuda.Stream(), torch.cuda.Stream()]
    for rnd in range(4):
        xs.copy_(_lanes(xs.shape, 27 + rnd, card))
        for s in replay_streams + [cap]:
            s.wait_stream(torch.cuda.current_stream())
        for graph, s in zip(graphs, replay_streams):
            with torch.cuda.stream(s):
                graph.replay()
        with torch.cuda.stream(cap):
            direct = [crc_kernel.crc32c_rows(xs[2, i]) for i in range(8)]
        torch.cuda.synchronize()
        for g in range(2):
            for i in range(8):
                assert torch.equal(outs[g][i], crc_kernel.crc32c_rows_plain(xs[g, i])), (
                    rnd, g, i)
        for i in range(8):
            assert torch.equal(direct[i], crc_kernel.crc32c_rows_plain(xs[2, i])), (rnd, i)


# 2**21 + 3 lanes over 3 rows: 513 chunks of 16 KiB, so the row fold
# takes runs of 4 chunks
@pytest.mark.parametrize("n32", [1, 5, 4095, 4097, 70001, (1 << 21) + 3])
def test_k4_any_row_length(card, n32):
    x = _lanes((3, n32), n32, card)
    got = crc_kernel.crc32c_rows(x).cpu().numpy().view(np.uint32)
    host = x.cpu().numpy()
    assert got.tolist() == [crc32c(host[i]) for i in range(3)]
    if n32 == (1 << 21) + 3:
        assert crc_kernel.geometry(3, n32, torch.cuda.get_device_properties(
            card).multi_processor_count)[2] > 1


def test_stage_pairs_on_the_card(card, tmp_path):
    rng = np.random.default_rng(0)
    data = rng.integers(0, 256, 3 * 10 * 65536 + 999, dtype=np.uint8).tobytes()
    blocks = dict(large_block_size=1 << 20, small_block_size=65536)
    gpu, ref = str(tmp_path / "g"), str(tmp_path / "c")
    for b in (gpu, ref):
        with open(b + ".dat", "wb") as f:
            f.write(data)
    gs, cs = {}, {}
    k1, k4 = codec_cuda.LAUNCHES.value, crc_kernel.LAUNCHES.value
    ec_files.write_ec_files(
        gpu, rs=new_encoder(backend="cuda"), buffer_size=131072, stats=gs,
        want_crcs=True, **blocks,
    )
    # one K4 launch a tile checksums its data and parity rows together
    assert codec_cuda.LAUNCHES.value - k1 == crc_kernel.LAUNCHES.value - k4 > 0
    ec_files.write_ec_files(
        ref, rs=new_encoder(backend="cpu"), buffer_size=65536, stats=cs,
        want_crcs=True, **blocks,
    )
    assert gs["shard_crcs"] == cs["shard_crcs"] and gs["host_crc_rows"] == 0
    for i in range(14):
        ext = ec_files.to_ext(i)
        assert open(gpu + ext, "rb").read() == open(ref + ext, "rb").read()
    for i in LOST4:
        os.remove(gpu + ec_files.to_ext(i))
    st = {}
    assert ec_files.rebuild_ec_files(
        gpu, rs=new_encoder(backend="cuda"), stats=st, want_crcs=True
    ) == list(LOST4)
    for i in LOST4:
        ext = ec_files.to_ext(i)
        assert open(gpu + ext, "rb").read() == open(ref + ext, "rb").read()
        assert st["shard_crcs"][i] == cs["shard_crcs"][i]


# --- K2 and K3: the batch kernels -------------------------------------------

DECODE4 = gf256.decode_rows(MATRIX, SURV4, LOST4)


@pytest.mark.parametrize("rows", [MATRIX[10:], DECODE4], ids=["encode", "decode4"])
@pytest.mark.parametrize("b", [1, 5])
def test_k2_equals_plain(card, rows, b):
    x = _lanes((b, 10, 65536), 3 + b, card)
    before = codec_cuda.BATCH_LAUNCHES.value
    got = codec_cuda.gf_apply_u32_batch(rows, x)
    torch.cuda.synchronize()
    assert codec_cuda.BATCH_LAUNCHES.value == before + 1  # one launch a batch
    assert torch.equal(got, codec_cuda.gf_apply_batch_plain(rows, x))
    assert torch.equal(got[b - 1], codec_cuda.gf_apply_u32(rows, x[b - 1]))


@pytest.mark.parametrize("n32", [1, 3, 1001, 4097])
def test_k2_k3_ragged_and_unaligned(card, n32):
    base = _lanes((3 * 10 * n32 + 1,), n32, card)
    x = base[1:].view(3, 10, n32)  # 4-byte aligned only: the scalar variant
    got = codec_cuda.gf_apply_u32_batch(DECODE4, x)
    assert torch.equal(got, codec_cuda.gf_apply_batch_plain(DECODE4, x))
    pbase = _lanes((3 * 4 * n32 + 1,), n32 + 1, card)
    parity = pbase[1:].view(3, 4, n32)
    parity.copy_(codec_cuda.gf_apply_batch_plain(MATRIX[10:], x))
    parity[1, 2, n32 - 1] ^= 5
    got = codec_cuda.gf_verify_u32_batch(MATRIX[10:], x, parity)
    assert got.tolist() == [0, 1, 0]
    assert torch.equal(got, codec_cuda.gf_verify_batch_plain(MATRIX[10:], x, parity))


def test_k2_writes_parity_rows_of_a_tile_in_place(card):
    tile = _lanes((6, 14, 8192), 11, card)
    data = tile[:, :10].clone()
    codec_cuda.gf_apply_u32_batch(MATRIX[10:], tile[:, :10], out=tile[:, 10:])
    assert torch.equal(tile[:, :10], data)
    assert torch.equal(tile[:, 10:], codec_cuda.gf_apply_batch_plain(MATRIX[10:], data))


def test_batch_tile_crc_equals_plain(card):
    """The fused batch encode on a batch tile (data part, then parity
    part): one K2 and one K4 launch, equal to the plain versions on the
    host."""
    kern = codec_cuda.CudaCodecKernels(device=card)
    tile = _lanes((5 * 14, 16384), 13, card)
    host = tile.cpu()
    counts = (codec_cuda.BATCH_LAUNCHES.value, crc_kernel.LAUNCHES.value)
    crcs = kern.encode_batch_tile_crc(tile)
    torch.cuda.synchronize()
    assert (codec_cuda.BATCH_LAUNCHES.value, crc_kernel.LAUNCHES.value) == (
        counts[0] + 1, counts[1] + 1)
    want = codec_cuda.CudaCodecKernels(device="cpu").encode_batch_tile_crc(host)
    assert torch.equal(tile.cpu(), host) and torch.equal(crcs.cpu(), want)


def test_k3_planted_mismatches(card):
    b = 70  # more volumes than blocks of a row: atomics from many blocks
    x = _lanes((b, 10, 16384), 12, card)
    parity = codec_cuda.gf_apply_batch_plain(MATRIX[10:], x)
    before = codec_cuda.VERIFY_LAUNCHES.value
    assert codec_cuda.gf_verify_u32_batch(MATRIX[10:], x, parity).tolist() == [0] * b
    want = [0] * b
    g = np.random.default_rng(0)
    for v in (0, 3, 64, 69):
        for _ in range(int(g.integers(1, 40))):
            p, lane = int(g.integers(0, 4)), int(g.integers(0, 16384))
            old = int(parity[v, p, lane])
            parity[v, p, lane] = old ^ int(g.integers(1, 2**31))
        want[v] = int((codec_cuda.gf_apply_batch_plain(MATRIX[10:], x[v : v + 1]) != parity[v : v + 1]).sum())
    got = codec_cuda.gf_verify_u32_batch(MATRIX[10:], x, parity)
    torch.cuda.synchronize()
    assert codec_cuda.VERIFY_LAUNCHES.value == before + 2
    assert got.tolist() == want
    assert torch.equal(got, codec_cuda.gf_verify_batch_plain(MATRIX[10:], x, parity))


def test_batch_drivers_on_the_card(card, tmp_path):
    from seaweedfs_tpu_torch.ec import ec_stream

    rng = np.random.default_rng(1)
    bases, refs = [], []
    for v in range(6):
        data = rng.integers(0, 256, 3 * 10 * 65536 + 977 * v, dtype=np.uint8).tobytes()
        for d, out in ((tmp_path / "g", bases), (tmp_path / "c", refs)):
            d.mkdir(exist_ok=True)
            out.append(str(d / f"{v + 1}"))
            with open(out[-1] + ".dat", "wb") as f:
                f.write(data)
    blocks = dict(large_block_size=1 << 20, small_block_size=65536)
    counts = (codec_cuda.BATCH_LAUNCHES.value, crc_kernel.LAUNCHES.value)
    gs = {}
    ec_files.write_ec_files_batch(bases, stats=gs, want_crcs=True, durable=True, **blocks)
    assert codec_cuda.BATCH_LAUNCHES.value > counts[0]
    assert crc_kernel.LAUNCHES.value > counts[1]
    assert gs["mesh"]["vol"] * gs["mesh"]["stripe"] == torch.cuda.device_count()
    assert gs["ring_pinned"] is True
    cpu = new_encoder(backend="cpu")
    for base, ref, crcs in zip(bases, refs, gs["shard_crcs"]):
        ec_files.write_ec_files(ref, rs=cpu, buffer_size=65536, **blocks)
        for i in range(14):
            ext = ec_files.to_ext(i)
            blob = open(base + ext, "rb").read()
            assert blob == open(ref + ext, "rb").read()
            assert crcs[i] == crc32c(blob)
    lost = [(3,) if v % 2 else LOST4 for v in range(6)]
    for base, ls in zip(bases, lost):
        for i in ls:
            os.remove(base + ec_files.to_ext(i))
    before = codec_cuda.BATCH_LAUNCHES.value
    st = {}
    got = ec_stream.stream_rebuild_ec_files_batch(bases, stats=st, want_crcs=True)
    assert got == [list(ls) for ls in lost] and st["batch_groups"] == 2
    assert codec_cuda.BATCH_LAUNCHES.value > before
    for base, ref, ls, crcs in zip(bases, refs, lost, st["shard_crcs"]):
        for i in ls:
            blob = open(base + ec_files.to_ext(i), "rb").read()
            assert blob == open(ref + ec_files.to_ext(i), "rb").read()
            assert crcs[i] == crc32c(blob)


def _degraded_volume(d: str, seed: int):
    """A ~12 MiB volume in `d` (one small row), encoded on the host,
    shards LOST4 deleted. Returns its needles [(id, offset, size)]."""
    from seaweedfs_tpu_torch.storage.synthetic import write_volume

    base = os.path.join(d, "1")
    _, entries = write_volume(base, 12 << 20, seed, max_payload=1 << 20)
    ec_files.write_ec_files(base, rs=new_encoder(backend="cpu"))
    ec_files.write_sorted_file_from_idx(base)
    for i in LOST4:
        os.remove(base + ec_files.to_ext(i))
    return entries


def test_degraded_read_on_the_card_equals_the_cpu_port(card, tmp_path):
    from seaweedfs_tpu_torch.ec.ec_volume import EcVolume

    entries = _degraded_volume(str(tmp_path), 4)
    gpu = EcVolume.load(str(tmp_path), 1, backend="cuda")  # device None: the card
    cpu = EcVolume.load(str(tmp_path), 1, backend="cuda", device="cpu")
    assert gpu.rs.device.type == "cuda" and cpu.rs.device.type == "cpu"
    k1, k4 = codec_cuda.LAUNCHES.value, crc_kernel.LAUNCHES.value
    for nid, off, size in entries:
        a, b = gpu.read_needle(nid), cpu.read_needle(nid)
        assert a.to_bytes() == b.to_bytes(), nid
    span = gpu.read_span(5000, 3 << 20)
    assert span == cpu.read_span(5000, 3 << 20)
    assert codec_cuda.LAUNCHES.value > k1  # decoded by K1 on the card
    assert crc_kernel.LAUNCHES.value == k4  # the read path checksums nothing
    gpu.close()
    cpu.close()


def test_eight_threads_decode_through_apply_matrix(card):
    import threading

    rng = np.random.default_rng(5)
    rows = gf256.decode_rows(MATRIX, SURV4, (0,))
    rows4 = gf256.decode_rows(MATRIX, SURV4, LOST4)
    jobs = [(rows if t % 2 else rows4,
             rng.integers(0, 256, (10, int(rng.integers(1, 3 << 20))), dtype=np.uint8))
            for t in range(8)]
    from seaweedfs_tpu_torch.ec.codec import cpu_apply_matrix

    want = [cpu_apply_matrix(r, x) for r, x in jobs]
    got: list = [None] * 8
    errors: list = []
    barrier = threading.Barrier(8)

    def run(t):
        try:
            barrier.wait(30)
            r, x = jobs[t]
            got[t] = [codec_cuda.cuda_apply_matrix(r, x) for _ in range(4)]
        except Exception as e:  # noqa: BLE001
            errors.append(e)

    before = codec_cuda.LAUNCHES.value
    threads = [threading.Thread(target=run, args=(t,)) for t in range(8)]
    for th in threads:
        th.start()
    for th in threads:
        th.join(120)
    assert not errors, errors[:1]
    assert codec_cuda.LAUNCHES.value - before == 32
    for t in range(8):
        for out in got[t]:
            assert np.array_equal(out, want[t]), t


def test_store_on_the_card(card, tmp_path):
    """Store with no ec_backend and no device: its EcVolume decodes with
    K1 on the card, equal to the store's own .dat records, and the
    volume it wrote and vacuumed encodes on the card and with the
    native host codec to the same bytes."""
    from seaweedfs_tpu_torch.storage.needle import Needle
    from seaweedfs_tpu_torch.storage.store import Store

    rng = np.random.default_rng(6)
    store = Store([str(tmp_path / "d")])
    v = store.add_volume(3)
    payload = {}
    for nid in range(1, 400):
        payload[nid] = rng.integers(0, 256, int(rng.integers(1, 60000)), dtype=np.uint8).tobytes()
        store.write_needle(3, Needle(cookie=nid, id=nid, data=payload[nid]))
    for nid in range(1, 400, 16):
        store.delete_needle(3, Needle(cookie=nid, id=nid))
        del payload[nid]
    v.compact()
    v.commit_compact()
    store.mark_volume_readonly(3)
    base = v.base_name
    native = str(tmp_path / "native")
    os.makedirs(native)
    os.symlink(base + ".dat", os.path.join(native, "3.dat"))
    gs, ns = {}, {}
    ec_files.write_ec_files(base, want_crcs=True, durable=True, stats=gs)
    ec_files.write_ec_files(os.path.join(native, "3"), rs=new_encoder(backend="native"),
                            want_crcs=True, stats=ns)
    assert gs["shard_crcs"] == ns["shard_crcs"]
    for i in range(14):
        ext = ec_files.to_ext(i)
        assert open(base + ext, "rb").read() == open(os.path.join(native, "3") + ext, "rb").read()
    ec_files.write_sorted_file_from_idx(base)
    ev = store.mount_ec_shards(3, "", list(range(14)))
    assert ev.rs.device.type == "cuda"
    store.unmount_ec_shards(3, list(LOST4))
    for i in LOST4:
        os.remove(base + ec_files.to_ext(i))
    before = codec_cuda.LAUNCHES.value
    for nid, data in payload.items():
        assert bytes(store.find_ec_volume(3).read_needle(nid).data) == data
    assert codec_cuda.LAUNCHES.value > before
    store.close()


# --- K5: the GF(2) bit-matrix apply ------------------------------------------


@pytest.mark.parametrize("b", [1, 3])
@pytest.mark.parametrize("n", [1, 7, 1024, 4099, 32768, 65535])
@pytest.mark.parametrize("c", [10, 6, 16])
@pytest.mark.parametrize("r", [1, 2, 4, 16])
def test_k5_equals_plain_and_tallies_its_signature(card, r, c, n, b):
    rng = np.random.default_rng(r * 1000 + c * 10 + b)
    a_bits = codec_cuda.gf_matrix_to_bits(rng.integers(0, 256, (r, c), dtype=np.uint8))
    g = torch.Generator(device=card).manual_seed(n)
    x = torch.randint(0, 256, (b, c, n), dtype=torch.uint8, device=card, generator=g)
    sig = (r, c, n, b, a_bits.tobytes())
    before = codec_cuda.BITS_LAUNCHES.by_signature().get(sig, 0)
    got = codec_cuda.apply_matrix_bits_batch(a_bits, x)
    torch.cuda.synchronize()
    assert torch.equal(got, codec_cuda.gf_bits_plain(a_bits, x))
    assert codec_cuda.BITS_LAUNCHES.by_signature()[sig] == before + 1


def test_k5_unaligned_and_lane_forms(card):
    """A byte view one off alignment (the scalar variant), and the u32
    lane wrappers equal to K1 and K2 on the same lanes."""
    rows = gf256.decode_rows(MATRIX, SURV4, (0,))
    a_bits = codec_cuda.gf_matrix_to_bits(rows)
    g = torch.Generator(device=card).manual_seed(3)
    raw = torch.randint(0, 256, (10 * 4096 + 1,), dtype=torch.uint8, device=card, generator=g)
    x = raw[1:].view(10, 4096)
    assert torch.equal(codec_cuda.apply_matrix_bits(a_bits, x),
                       codec_cuda.gf_bits_plain(a_bits, x[None])[0])
    lanes = _lanes((3, 10, 2048), 4, card)
    assert torch.equal(codec_cuda.apply_matrix_bits_u32_batch(a_bits, lanes),
                       codec_cuda.gf_apply_u32_batch(rows, lanes))
    assert torch.equal(codec_cuda.apply_matrix_bits_u32(a_bits, lanes[0]),
                       codec_cuda.gf_apply_u32(rows, lanes[0]))


def _k5_draws(count: int, seed: int):
    """(R, C, B, n, offset, arm): R and C over 1..16, B over 1..3, each
    draw on one arm of the dispatch: aligned word-multiple n (the
    tensor-core arm, ragged against the 32 columns of a warp half the
    time), a pointer one byte off, or n not a multiple of 4 (the ALU
    arm)."""
    rng = np.random.default_rng(seed)
    out = []
    for i in range(count):
        r, c, b = int(rng.integers(1, 17)), int(rng.integers(1, 17)), int(rng.integers(1, 4))
        kind = ("aligned", "ragged_warp", "unaligned", "ragged_n")[i % 4]
        n = 4 * int(rng.integers(1, 3000))
        if kind == "aligned":
            n = 32 * int(rng.integers(1, 1100))
        elif kind == "ragged_warp":
            n = 32 * int(rng.integers(0, 1100)) + 4 * int(rng.integers(1, 8))
        elif kind == "ragged_n":
            n += int(rng.integers(1, 4))
        arm = "mma" if kind in ("aligned", "ragged_warp") else "alu"
        out.append(pytest.param(r, c, b, n, int(kind == "unaligned"), arm,
                                id=f"{kind}-R{r}-C{c}-B{b}-n{n}"))
    return out


@pytest.mark.parametrize("r, c, b, n, offset, arm", _k5_draws(32, 77))
def test_k5_arms_equal_plain(card, r, c, b, n, offset, arm):
    """Both arms of K5's dispatch against the plain version, each call on
    the arm its shape picks, as the arm counts show."""
    rng = np.random.default_rng(r * 1000 + c * 10 + b + n)
    a_bits = codec_cuda.gf_matrix_to_bits(rng.integers(0, 256, (r, c), dtype=np.uint8))
    g = torch.Generator(device=card).manual_seed(n)
    raw = torch.randint(0, 256, (b * c * n + offset,), dtype=torch.uint8, device=card,
                        generator=g)
    x = raw[offset:].view(b, c, n)
    counts = {"mma": codec_cuda.BITS_MMA_LAUNCHES, "alu": codec_cuda.BITS_ALU_LAUNCHES}
    before = {k: v.value for k, v in counts.items()}
    got = codec_cuda.apply_matrix_bits_batch(a_bits, x)
    torch.cuda.synchronize()
    assert torch.equal(got, codec_cuda.gf_bits_plain(a_bits, x))
    assert {k: v.value - before[k] for k, v in counts.items()} == {
        k: int(k == arm) for k in counts}


def test_k5_batch_past_grid_limit(card):
    """A batch of more items than a grid's y (65535) takes the
    tensor-core arm, in two launches, equal to the plain version."""
    rng = np.random.default_rng(70000)
    a_bits = codec_cuda.gf_matrix_to_bits(rng.integers(0, 256, (2, 3), dtype=np.uint8))
    g = torch.Generator(device=card).manual_seed(70000)
    x = torch.randint(0, 256, (70000, 3, 8), dtype=torch.uint8, device=card, generator=g)
    arm0 = codec_cuda.BITS_MMA_LAUNCHES.value
    got = codec_cuda.apply_matrix_bits_batch(a_bits, x)
    torch.cuda.synchronize()
    assert codec_cuda.BITS_MMA_LAUNCHES.value == arm0 + 2
    assert torch.equal(got, codec_cuda.gf_bits_plain(a_bits, x))


def test_k5_graphs_on_two_streams_equal_serial(card):
    """The same K5 calls (the serving path's 1-row decode at 32 KiB and a
    4-row decode at 4 KiB, tensor-core arm) captured in two CUDA graphs
    and replayed at once on two streams, three rounds with the inputs
    rewritten: equal to the calls run one after the other."""
    rows1 = gf256.decode_rows(MATRIX, SURV4, (0,))
    rows4 = gf256.decode_rows(MATRIX, SURV4, LOST4)
    mats = [codec_cuda.gf_matrix_to_bits(rows1), codec_cuda.gf_matrix_to_bits(rows4)]
    xs = [torch.zeros((8, 1, 10, 32768), dtype=torch.uint8, device=card),
          torch.zeros((8, 1, 10, 4096), dtype=torch.uint8, device=card)]
    cap = torch.cuda.Stream()
    cap.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(cap):  # the library's first call, outside the capture
        codec_cuda.apply_matrix_bits_batch(mats[0], xs[0][0])
    torch.cuda.synchronize()
    graphs, outs = [], []
    arm0 = codec_cuda.BITS_MMA_LAUNCHES.value
    for a_bits, x in zip(mats, xs):
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph, stream=cap):
            outs.append([codec_cuda.apply_matrix_bits_batch(a_bits, x[i]) for i in range(8)])
        graphs.append(graph)
    assert codec_cuda.BITS_MMA_LAUNCHES.value == arm0 + 16
    streams = [torch.cuda.Stream(), torch.cuda.Stream()]
    for rnd in range(3):
        for j, x in enumerate(xs):
            g = torch.Generator(device=card).manual_seed(100 * rnd + j)
            x.copy_(torch.randint(0, 256, x.shape, dtype=torch.uint8, device=card,
                                  generator=g))
        for s in streams:
            s.wait_stream(torch.cuda.current_stream())
        for graph, s in zip(graphs, streams):
            with torch.cuda.stream(s):
                graph.replay()
        torch.cuda.synchronize()
        for a_bits, x, got in zip(mats, xs, outs):
            serial = [codec_cuda.apply_matrix_bits_batch(a_bits, x[i]) for i in range(8)]
            for i in range(8):
                assert torch.equal(got[i], serial[i]), (rnd, i)
                assert torch.equal(got[i], codec_cuda.gf_bits_plain(a_bits, x[i])), (rnd, i)


@pytest.mark.parametrize("n, k5", [(100, 1), (32768, 1), (32769, 0), (70000, 0)])
def test_cuda_apply_matrix_takes_k5_under_64k(card, n, k5):
    from seaweedfs_tpu_torch.ec.codec import cpu_apply_matrix

    rows = gf256.decode_rows(MATRIX, SURV4, (5,))
    x = np.random.default_rng(n).integers(0, 256, (10, n), dtype=np.uint8)
    b0, k0 = codec_cuda.BITS_LAUNCHES.value, codec_cuda.LAUNCHES.value
    got = codec_cuda.cuda_apply_matrix(rows, x)
    assert np.array_equal(got, cpu_apply_matrix(rows, x))
    assert codec_cuda.BITS_LAUNCHES.value - b0 == k5
    assert codec_cuda.LAUNCHES.value - k0 == 1 - k5


# --- the volume server on the card -------------------------------------------


def _server(d):
    import random
    import socket

    from seaweedfs_tpu_torch.server.volume_server import VolumeServer

    for _ in range(100):
        port = random.randrange(20000, 50000)
        try:
            for p in (port, port + 10000):
                with socket.socket() as s:
                    s.bind(("127.0.0.1", p))
        except OSError:
            continue
        vs = VolumeServer([d], port=port, ec_codec="cuda", scrub_interval=0)
        vs.start()
        return vs
    raise RuntimeError("no free port pair")


def _post(port, fid, body):
    import http.client

    c = http.client.HTTPConnection("127.0.0.1", port, timeout=60)
    try:
        c.request("POST", f"/{fid}", body=body)
        r = c.getresponse()
        assert r.status == 201, r.read()
        r.read()
    finally:
        c.close()


def test_server_two_generates_at_once_equal_serial(card, tmp_path):
    """Two VolumeEcShardsGenerate calls at once on the card give the
    shards and .ecc of the same encodes run one after the other."""
    import shutil
    import threading

    from seaweedfs_tpu_torch.ec import ecc_sidecar
    from seaweedfs_tpu_torch.pb import rpc, volume_pb2 as pb

    d = str(tmp_path / "srv")
    os.makedirs(d)
    vs = _server(d)
    try:
        with rpc.dial(f"127.0.0.1:{vs.grpc_port}") as ch:
            stub = rpc.volume_stub(ch)
            rng = np.random.default_rng(8)
            for vid in (31, 32):
                stub.AllocateVolume(pb.AllocateVolumeRequest(volume_id=vid))
                for i in range(40):
                    _post(vs.port, f"{vid},{i + 1:x}00001234",
                          rng.bytes(int(rng.integers(1000, 1 << 20))))
                stub.VolumeMarkReadonly(pb.VolumeMarkReadonlyRequest(volume_id=vid))
            serial = str(tmp_path / "serial")
            os.makedirs(serial)
            for vid in (31, 32):
                for ext in (".dat", ".idx"):
                    shutil.copyfile(os.path.join(d, f"{vid}{ext}"),
                                    os.path.join(serial, f"{vid}{ext}"))
            errors: list = []

            def gen(vid):
                try:
                    stub.VolumeEcShardsGenerate(
                        pb.VolumeEcShardsGenerateRequest(volume_id=vid), timeout=300)
                except Exception as e:  # noqa: BLE001
                    errors.append(e)

            before = codec_cuda.LAUNCHES.value
            threads = [threading.Thread(target=gen, args=(v,)) for v in (31, 32)]
            for t in threads:
                t.start()
            for t in threads:
                t.join(300)
            assert not errors and not any(t.is_alive() for t in threads)
            assert codec_cuda.LAUNCHES.value > before
        rs = new_encoder(backend="cuda")
        for vid in (31, 32):
            base = os.path.join(serial, str(vid))
            st: dict = {}
            ec_files.write_ec_files(base, rs=rs, want_crcs=True, durable=True, stats=st)
            ecc_sidecar.write_sidecar(base, st["shard_crcs"])
            for ext in [ec_files.to_ext(i) for i in range(14)] + [".ecc"]:
                with open(base + ext, "rb") as a, open(os.path.join(d, f"{vid}{ext}"), "rb") as b:
                    assert a.read() == b.read(), (vid, ext)
    finally:
        vs.stop()


def test_cluster_rebuild_beside_degraded_gets_equals_serial(card, tmp_path):
    """Three servers and a master on one card, booted by start_cluster: A
    (the server the one grown volume lands on) generates and spreads (B
    4-8, C 9-13), A stops; 8 HammerReaders GET every needle through B
    (decodes from B's and C's survivors on per-call streams) while B
    rebuilds 0-3 reading 9-13 off C (K4 on its stage stream), and go on
    reading after it. Every body equals its payload and B's rebuilt
    shards equal A's generated ones, as when the GETs and the rebuild
    run one after the other. (A never mounts its shards: it only sources
    the copies.)"""
    import json
    import time
    import urllib.request

    from seaweedfs_tpu_torch.pb import master_pb2, rpc, volume_pb2 as pb
    from seaweedfs_tpu_torch.util.availability import (
        HammerReader,
        run_with_readers,
        start_cluster,
    )

    def wait(cond, timeout=60.0):
        deadline = time.time() + timeout
        while not cond():
            assert time.time() < deadline
            time.sleep(0.02)

    dirs = [str(tmp_path / f"vs{i}") for i in range(3)]
    for d in dirs:
        os.makedirs(d)
    master, servers = start_cluster(dirs, volume_size_limit_mb=256, ec_codec="cuda",
                                    scrub_interval=0)
    stubs = []
    try:
        urllib.request.urlopen(f"http://127.0.0.1:{master.port}/vol/grow"
                               f"?collection=ec&count=1", timeout=60).read()
        rng = np.random.default_rng(31)
        bodies = {}
        for _ in range(48):
            with urllib.request.urlopen(f"http://127.0.0.1:{master.port}/dir/assign"
                                        f"?collection=ec", timeout=30) as r:
                assign = json.loads(r.read())
            body = rng.bytes(int(np.exp(rng.uniform(np.log(1024), np.log(1 << 20)))))
            _post(int(assign["url"].rsplit(":", 1)[1]), assign["fid"], body)
            bodies[assign["fid"]] = body
        vid = int(next(iter(bodies)).split(",")[0])
        a_url = assign["url"]
        a = next(i for i, vs in enumerate(servers) if f"127.0.0.1:{vs.port}" == a_url)
        servers[:] = [servers[a]] + [vs for i, vs in enumerate(servers) if i != a]
        for vs in servers:
            ch = rpc.dial(f"127.0.0.1:{vs.grpc_port}")
            stubs.append((ch, rpc.volume_stub(ch)))
        sa, sb, sc = (s for _, s in stubs)
        sa.VolumeMarkReadonly(pb.VolumeMarkReadonlyRequest(volume_id=vid))
        sa.VolumeEcShardsGenerate(pb.VolumeEcShardsGenerateRequest(volume_id=vid,
                                                                   collection="ec"))
        for s, sids in ((sb, list(range(4, 9))), (sc, list(range(9, 14)))):
            s.VolumeEcShardsCopy(pb.VolumeEcShardsCopyRequest(
                volume_id=vid, collection="ec", shard_ids=sids, copy_ecx_file=True,
                source_data_node=a_url))
            s.VolumeEcShardsMount(pb.VolumeEcShardsMountRequest(
                volume_id=vid, collection="ec", shard_ids=sids))
        sa.VolumeEcShardsDelete(pb.VolumeEcShardsDeleteRequest(
            volume_id=vid, collection="ec", shard_ids=list(range(4, 14))))
        sa.VolumeDelete(pb.VolumeDeleteRequest(volume_id=vid))

        def holders():
            with rpc.dial(f"127.0.0.1:{master.grpc_port}") as ch:
                resp = rpc.master_stub(ch).LookupEcVolume(
                    master_pb2.LookupEcVolumeRequest(volume_id=vid))
            return {e.shard_id for e in resp.shard_id_locations}

        wait(lambda: holders() == set(range(4, 14)))
        base_a = os.path.join(servers[0].store.locations[0].directory, f"ec_{vid}")
        servers.pop(0).stop()
        fids = list(bodies)
        readers = [HammerReader(f"http://127.0.0.1:{servers[0].port}",
                                {fid: bodies[fid] for fid in fids[t::8]}, f"reader{t}")
                   for t in range(8)]
        before = (codec_cuda.LAUNCHES.value, crc_kernel.LAUNCHES.value)
        rebuilt = []
        run_with_readers(readers, lambda: rebuilt.append(sb.VolumeEcShardsRebuild(
            pb.VolumeEcShardsRebuildRequest(volume_id=vid, collection="ec"), timeout=300)))
        failures = [f for r in readers for f in r.failures]
        assert failures == [] and not any(r.is_alive() for r in readers), failures[:5]
        assert all(r.reads >= len(r.keys) for r in readers), [r.reads for r in readers]
        assert list(rebuilt[0].rebuilt_shard_ids) == [0, 1, 2, 3]
        assert codec_cuda.LAUNCHES.value > before[0] and crc_kernel.LAUNCHES.value > before[1]
        base_b = os.path.join(servers[0].store.locations[0].directory, f"ec_{vid}")
        for i in range(4):
            ext = ec_files.to_ext(i)
            with open(base_a + ext, "rb") as x, open(base_b + ext, "rb") as y:
                assert x.read() == y.read(), ext
    finally:
        for ch, _ in stubs:
            ch.close()
        for vs in servers:
            vs.stop()
        master.stop()


def test_server_batch_generate_on_the_card(card, tmp_path):
    """VolumeEcShardsBatchGenerate on a card server: K2 (and K4 on the
    full-width rounds) launch, and every volume's shards, .ecx and .ecc
    equal the native host codec's encode of the same .dat, one volume at
    a time."""
    import shutil

    from seaweedfs_tpu_torch.ec import ecc_sidecar
    from seaweedfs_tpu_torch.pb import rpc, volume_pb2 as pb
    from seaweedfs_tpu_torch.storage.synthetic import write_volume

    d = str(tmp_path / "srv")
    os.makedirs(d)
    vids = list(range(41, 49))
    for vid in vids:
        write_volume(os.path.join(d, str(vid)), (3 << 20) + 65536 * vid, vid,
                     max_payload=1 << 20)
    ref = str(tmp_path / "ref")
    os.makedirs(ref)
    native = new_encoder(backend="native")
    for vid in vids:
        base = os.path.join(ref, str(vid))
        for ext in (".dat", ".idx"):
            shutil.copyfile(os.path.join(d, f"{vid}{ext}"), base + ext)
        st: dict = {}
        ec_files.write_ec_files(base, rs=native, want_crcs=True, stats=st)
        ec_files.write_sorted_file_from_idx(base)
        ecc_sidecar.write_sidecar(base, st["shard_crcs"])
    vs = _server(d)
    try:
        k2, k4 = codec_cuda.BATCH_LAUNCHES.value, crc_kernel.LAUNCHES.value
        with rpc.dial(f"127.0.0.1:{vs.grpc_port}") as ch:
            stub = rpc.volume_stub(ch)
            for vid in vids:
                stub.VolumeMarkReadonly(pb.VolumeMarkReadonlyRequest(volume_id=vid))
            stub.VolumeEcShardsBatchGenerate(
                pb.VolumeEcShardsBatchGenerateRequest(volume_ids=vids), timeout=300)
        assert codec_cuda.BATCH_LAUNCHES.value > k2
        assert crc_kernel.LAUNCHES.value > k4
        for vid in vids:
            for ext in [ec_files.to_ext(i) for i in range(14)] + [".ecx", ".ecc"]:
                with open(os.path.join(ref, f"{vid}{ext}"), "rb") as a, open(
                        os.path.join(d, f"{vid}{ext}"), "rb") as b:
                    assert a.read() == b.read(), (vid, ext)
    finally:
        vs.stop()


@pytest.mark.parametrize("corrupt", [(), ((3, 1000),), ((12, (4 << 20) - 7),),
                                     ((1, 5), (13, 77))], ids=["clean", "data", "parity", "pair"])
def test_scrub_verify_and_localize_4mib_tile_equal_plain(card, corrupt):
    """The scrub's parity re-verify on one 4 MiB tile of 14 shards, and
    the localization of its culprits: on the card (K1, one re-encode
    launch for the tile, then the hypotheses' decodes and re-encodes)
    and on K1's plain version, with the same mismatch counts and
    culprits."""
    from seaweedfs_tpu_torch.scrub.verify import verify_parity_stream

    tile = 4 << 20
    rng = np.random.default_rng(5)
    shards = [rng.integers(0, 256, tile, dtype=np.uint8) for _ in range(10)] + [None] * 4
    new_encoder(backend="cuda", device="cpu").encode(shards)
    tiles = [bytearray(s.tobytes()) for s in shards]
    for sid, off in corrupt:
        tiles[sid][off] ^= 0x5A
    tiles = [bytes(t) for t in tiles]
    readers = [lambda off, size, _t=t: _t[off: off + size] for t in tiles]
    got = {}
    for dev in ("cuda", "cpu"):
        before = codec_cuda.LAUNCHES.value
        res = verify_parity_stream(readers, rs=new_encoder(backend="cuda", device=dev),
                                   tile_bytes=tile)
        got[dev] = (res.mismatch, res.culprits, res.unlocalized, res.bad_tiles,
                    res.bytes_per_shard, codec_cuda.LAUNCHES.value - before)
    assert got["cuda"][:5] == got["cpu"][:5]
    assert got["cpu"][5] == 0  # plain versions are not launches
    assert got["cuda"][5] == 1 if not corrupt else got["cuda"][5] > 1
    assert sorted(got["cuda"][1]) == sorted(sid for sid, _ in corrupt)
