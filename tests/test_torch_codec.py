"""The port's codec and its two kernels' plain versions against
seaweedfs_tpu, on the CPU.

K1 (GF(2^8) apply) is held against the reference's Pallas SWAR kernel
in interpret mode and against its numpy `cpu` codec; K4 (row CRC-32C)
against the reference's XLA CRC program and the host CRC. The same
numpy arrays go to both packages; tolerance 0 (integer math).
"""

import os

import numpy as np
import pytest
import torch

from seaweedfs_tpu.ec import codec as ref_codec
from seaweedfs_tpu.ec import codec_tpu as ref_codec_tpu
from seaweedfs_tpu.ec import crc_kernel as ref_crc_kernel
from seaweedfs_tpu.ec import gf256 as ref_gf
from seaweedfs_tpu.util import crc as ref_crc
from seaweedfs_tpu_torch.ec import codec, codec_cuda, crc_kernel

REF_MATRIX = ref_gf.build_code_matrix(10, 14)
LOST4 = (0, 5, 12, 13)
SURV4 = tuple(i for i in range(14) if i not in LOST4)
MATRICES = {
    "parity": REF_MATRIX[10:],
    "decode4": ref_gf.decode_rows(REF_MATRIX, SURV4, LOST4),
    "decode1": ref_gf.decode_rows(REF_MATRIX, tuple(range(1, 11)), (0,)),
}


def _u32(a: np.ndarray) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(a).view(np.int32))


@pytest.mark.parametrize("name", sorted(MATRICES))
@pytest.mark.parametrize("nbytes", [1024, 16 * 1024, 64 * 1024])
def test_plain_k1_equals_pallas_interpret_and_cpu(name, nbytes):
    rows = MATRICES[name]
    data = np.random.default_rng(nbytes + len(name)).integers(
        0, 256, (10, nbytes), dtype=np.uint8
    )
    got = codec_cuda.gf_apply_u32(rows, _u32(data)).numpy().view(np.uint8)
    np.testing.assert_array_equal(
        got, ref_codec_tpu.swar_apply_matrix_host(rows, data, interpret=True)
    )
    np.testing.assert_array_equal(got, ref_codec.cpu_apply_matrix(rows, data))


@pytest.mark.parametrize("n32", [1, 3, 255, 1000])
def test_plain_k1_ragged_lane_counts(n32):
    data = np.random.default_rng(n32).integers(0, 256, (10, 4 * n32), dtype=np.uint8)
    got = codec_cuda.gf_apply_u32(MATRICES["decode4"], _u32(data))
    np.testing.assert_array_equal(
        got.numpy().view(np.uint8),
        ref_codec.cpu_apply_matrix(MATRICES["decode4"], data),
    )


def test_gf_masks_match_reference_schedule():
    """The kernels' term words select exactly the reference schedule's
    (row, bit) column sets, and maxj is its Horner start."""
    for rows in MATRICES.values():
        r, k = rows.shape
        sel, maxj, _ = ref_codec_tpu._swar_schedule(
            tuple(int(v) for v in rows.reshape(-1)), r, k
        )
        words, got_maxj = codec_cuda.gf_terms(rows)
        assert words.shape == (r, 8, k) and words.dtype == np.uint32
        assert set(np.unique(words).tolist()) <= {0, 0xFFFFFFFF}
        assert got_maxj.tolist() == maxj
        for p in range(r):
            for j in range(8):
                assert [c for c in range(k) if words[p, j, c]] == sel[p][j]


def test_gf_apply_out_and_validation():
    data = np.random.default_rng(1).integers(0, 256, (10, 4096), dtype=np.uint8)
    out = torch.empty((4, 1024), dtype=torch.int32)
    got = codec_cuda.gf_apply_u32(MATRICES["parity"], _u32(data), out=out)
    assert got is out
    np.testing.assert_array_equal(
        out.numpy().view(np.uint8), ref_codec.cpu_apply_matrix(MATRICES["parity"], data)
    )
    with pytest.raises(ValueError):
        codec_cuda.gf_apply_u32(MATRICES["parity"], _u32(data[:9]))
    with pytest.raises(ValueError):
        codec_cuda.gf_apply_u32(MATRICES["parity"], _u32(data).to(torch.int64))


@pytest.mark.parametrize("n32", [1, 4096])
def test_plain_k4_equals_reference_rows(n32):
    x = np.random.default_rng(n32).integers(0, 2**32, (14, n32), dtype=np.uint32)
    got = crc_kernel.crc32c_rows(_u32(x)).numpy().view(np.uint32)
    want = np.asarray(ref_crc_kernel.crc32c_rows(x))
    np.testing.assert_array_equal(got, want)
    assert got.tolist() == [ref_crc.crc32c(x[i].tobytes()) for i in range(14)]
    lin = crc_kernel.crc_lin_rows(_u32(x))
    np.testing.assert_array_equal(
        lin.numpy().view(np.uint32), np.asarray(ref_crc_kernel.crc_lin_rows(x))
    )
    np.testing.assert_array_equal(
        crc_kernel.finalize_rows(lin, 4 * n32).numpy().view(np.uint32), want
    )


@pytest.mark.parametrize("n32", [3, 4097, 5000])
def test_plain_k4_any_lane_count(n32):
    # the kernel and its plain version take any row length (front zero
    # padding leaves a raw CRC unchanged); the driver contract stays
    # power-of-two lanes
    x = np.random.default_rng(n32).integers(0, 2**32, (2, n32), dtype=np.uint32)
    got = crc_kernel.crc32c_rows(_u32(x)).numpy().view(np.uint32)
    assert got.tolist() == [ref_crc.crc32c(x[i].tobytes()) for i in range(2)]
    assert not crc_kernel.crc_supported(4 * n32)
    assert crc_kernel.crc_supported(4 * 4096)
    assert crc_kernel.crc_supported(4 * 4096) == ref_crc_kernel.crc_supported(4 * 4096)


def _op(z: np.ndarray, base: int, m: int, j: int) -> list[int]:
    """Operator j of the [32][m] family at `base` in kernel_zcols."""
    return [int(z[base + b * m + j]) for b in range(32)]


def _run(nchunks: int) -> int:
    run = 1
    while 256 * run < nchunks:
        run *= 2
    return run


@pytest.mark.parametrize(
    "span,run", [(16, 1), (32, 1), (64, 1), (16, 2), (32, 8), (64, 4), (64, 16)]
)
def test_kernel_zcols_are_zero_shift_operators(span, run):
    z = crc_kernel.kernel_zcols(span, run)
    assert z.shape == (2592,)
    chunk = 256 * span
    for lane in range(32):
        assert _op(z, 0, 32, lane) == ref_crc._zero_shift_cols(span * (31 - lane))
        assert _op(z, 1312, 32, lane) == ref_crc._zero_shift_cols(chunk * run * (31 - lane))
    for w in range(8):
        assert _op(z, 1024, 8, w) == ref_crc._zero_shift_cols(32 * span * (7 - w))
        assert _op(z, 2336, 8, w) == ref_crc._zero_shift_cols(chunk * run * 32 * (7 - w))
    assert _op(z, 1280, 1, 0) == ref_crc._zero_shift_cols(chunk)
    assert crc_kernel._lane_cols() == ref_crc_kernel._lane_cols()


def test_k4_byte_table_is_the_crc32c_table():
    table = crc_kernel.byte_table()
    assert [crc_kernel._raw_transit(bytes([b]), 0) for b in range(256)] == list(table)


def _thread_crc(table, words: np.ndarray) -> int:
    """A thread's span in csrc/crc32c_rows.cu: per word, XOR it in, then
    four Sarwate steps through the byte table."""
    c = 0
    for w in words.tolist():
        c ^= w
        for _ in range(4):
            c = table[c & 0xFF] ^ (c >> 8)
    return c


def _combine(z, lane_base, warp_base, pieces):
    """block_combine of csrc/crc32c_rows.cu on the host: 256 piece CRCs
    -> one, through the lane and warp operator families."""
    warps = []
    for w in range(8):
        c = 0
        for lane in range(32):
            c ^= ref_crc._gf2_apply(_op(z, lane_base, 32, lane), pieces[32 * w + lane])
        warps.append(c)
    c = 0
    for w in range(8):
        c ^= ref_crc._gf2_apply(_op(z, warp_base, 8, w), warps[w])
    return c


@pytest.mark.parametrize(
    "span,nchunks", [(16, 1), (16, 300), (32, 3), (32, 1025), (64, 1), (64, 257)]
)
def test_k4_row_fold_order(span, nchunks):
    """The steps of csrc/crc32c_rows.cu on the host for a span the host
    can choose: thread spans through the byte table, thread pieces ->
    chunk CRCs, then (more than one chunk) front zero chunks, serial
    runs and runs -> row, over the kernel's Z columns, equal the row's
    CRC."""
    span_words = span // 4
    chunk_words = 256 * span_words
    n32 = nchunks * chunk_words - 5  # a ragged row: front-padded by 5 lanes
    row = np.random.default_rng(nchunks + span).integers(0, 2**32, n32, dtype=np.uint32)
    padded = np.concatenate([np.zeros(5, dtype=np.uint32), row])
    run = _run(nchunks)
    z = crc_kernel.kernel_zcols(span, run)
    table = crc_kernel.byte_table()
    parts = []
    for i in range(nchunks):
        chunk = padded[i * chunk_words : (i + 1) * chunk_words]
        if i < 2:  # the in-chunk steps, on the first chunks (slow in Python)
            pieces = [_thread_crc(table, chunk[t * span_words : (t + 1) * span_words])
                      for t in range(256)]
            assert pieces[255] == crc_kernel._raw_transit(chunk[-span_words:].tobytes(), 0)
            parts.append(_combine(z, 0, 1024, pieces))
            assert parts[-1] == crc_kernel._raw_transit(chunk.tobytes(), 0)
        else:
            parts.append(crc_kernel._raw_transit(chunk.tobytes(), 0))
    if nchunks == 1:  # the kernel skips the tickets and the fold
        got = parts[0]
    else:
        leaves = [0] * (256 * run - nchunks) + parts
        runs = []
        for t in range(256):
            c = leaves[t * run]
            for v in leaves[t * run + 1 : (t + 1) * run]:
                c = ref_crc._gf2_apply(_op(z, 1280, 1, 0), c) ^ v
            runs.append(c)
        got = _combine(z, 1312, 2336, runs)
    assert got == crc_kernel._raw_transit(row.tobytes(), 0)
    assert got ^ crc_kernel._final_const(4 * n32) == ref_crc.crc32c(row.tobytes())


# K4's shapes on the paths (rows of 1 MiB) -> (span, blocks) on 132 SMs
K4_SHAPES = {1: (16, 256), 4: (32, 512), 14: (64, 896), 224: (64, 14336)}


@pytest.mark.parametrize("rows", sorted(K4_SHAPES))
def test_k4_geometry_fills_the_card(rows):
    """The host's choice at the paths' shapes: the grid reaches all 132
    SMs, and no span with fewer waves x (span + 64) byte steps reaches
    them too."""
    n32 = 262144
    span, nchunks, run = crc_kernel.geometry(rows, n32)
    blocks = rows * nchunks
    assert (span, blocks) == K4_SHAPES[rows]
    assert (nchunks - 1) * 256 * span < 4 * n32 <= nchunks * 256 * span
    assert run == _run(nchunks) == 1
    assert blocks >= 132

    def cost(s):
        b = rows * -(-4 * n32 // (256 * s))
        return -(-b // 792) * (s + 64) if b >= 132 else float("inf")

    assert cost(span) == min(cost(s) for s in crc_kernel.SPANS)


@pytest.mark.parametrize(
    "rows,n32,want", [(1, 1, (16, 1, 1)), (300, 5, (16, 1, 1)),
                      (1, (1 << 21) + 3, (64, 513, 4)), (3, (1 << 21) + 3, (64, 513, 4))]
)
def test_k4_geometry_edges(rows, n32, want):
    """Rows too short to reach every SM take the smallest span; long
    rows fold runs of several chunks."""
    span, nchunks, run = crc_kernel.geometry(rows, n32)
    assert (span, nchunks, run) == want
    assert run == _run(nchunks) and span in crc_kernel.SPANS


def test_k4_table_copy_layout():
    """The block's copy of the device table (each entry four times, one
    16-byte slot q from entry q // 8) puts entry b of lane l's copy at
    word 32 b + l, the word the lookup reads."""
    table4 = np.repeat(np.array(crc_kernel.byte_table(), dtype=np.uint32), 4)
    tab = np.concatenate([table4[4 * (q >> 3) : 4 * (q >> 3) + 4] for q in range(2048)])
    for b in range(256):
        for lane in range(32):
            offset = ((b << 7) & 0x7F80) | (4 * lane)  # the kernel's byte address
            assert tab[offset // 4] == crc_kernel.byte_table()[b]


def _shards(n: int, seed: int):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, 256, n, dtype=np.uint8) for _ in range(10)] + [None] * 4


@pytest.mark.parametrize("n", [1, 1000, 4096, 70001])
def test_reedsolomon_cuda_on_cpu_matches_reference(n):
    port = codec.new_encoder(backend="cuda", device="cpu")
    ref = ref_codec.new_encoder(backend="cpu")
    got = port.encode(_shards(n, n))
    want = ref.encode(_shards(n, n))
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a, b)
    assert port.verify(got) and ref.verify(got)
    for lost in [(3,), (0, 13), (1, 2, 11), LOST4, (10, 11, 12, 13)]:
        a = [None if i in lost else s.copy() for i, s in enumerate(got)]
        b = [None if i in lost else s.copy() for i, s in enumerate(got)]
        port.reconstruct(a)
        ref.reconstruct(b)
        for x, y, orig in zip(a, b, got):
            np.testing.assert_array_equal(x, y)
            np.testing.assert_array_equal(x, orig)
        a = [None if i in lost else s.copy() for i, s in enumerate(got)]
        port.reconstruct_data(a)
        assert all(a[i] is None for i in lost if i >= 10)
        np.testing.assert_array_equal(port.decode_rows(SURV4, LOST4), ref.decode_rows(SURV4, LOST4))
    stacked = np.stack(got[:10])
    p1, c1 = port.parity_with_crc(stacked)
    p2, c2 = ref.parity_with_crc(stacked)
    np.testing.assert_array_equal(p1, p2)
    assert c1 == c2


def test_cpu_backend_matches_reference():
    port = codec.new_encoder(backend="cpu")
    ref = ref_codec.new_encoder(backend="cpu")
    for a, b in zip(port.encode(_shards(5000, 2)), ref.encode(_shards(5000, 2))):
        np.testing.assert_array_equal(a, b)


def test_cuda_backend_needs_a_card_unless_cpu_is_asked(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    data = np.zeros((10, 64), dtype=np.uint8)
    with pytest.raises(RuntimeError):
        codec_cuda.cuda_apply_matrix(MATRICES["parity"], data)
    with pytest.raises(RuntimeError):
        codec.new_encoder(backend="cuda")
    with pytest.raises(RuntimeError):
        codec_cuda.CudaCodecKernels()
    out = codec_cuda.cuda_apply_matrix(MATRICES["parity"], data, device="cpu")
    assert out.shape == (4, 64) and not out.any()


def test_default_backend(monkeypatch):
    monkeypatch.delenv("WEED_EC_CODEC", raising=False)
    assert codec.default_backend() == "cuda"
    monkeypatch.setenv("WEED_EC_CODEC", "cpu")
    assert codec.default_backend() == "cpu"
    monkeypatch.setenv("WEED_EC_CODEC", "native")
    assert codec.default_backend() == "native"
    monkeypatch.setenv("WEED_EC_CODEC", "tpu")
    with pytest.raises(ValueError):
        codec.default_backend()
    with pytest.raises(ValueError):
        codec.new_encoder(backend="tpu")


def test_codec_state_from_reference_matrix():
    state = codec_cuda.codec_state_from_numpy(ref_codec_tpu.TpuCodecKernels().matrix)
    np.testing.assert_array_equal(state.matrix, codec.new_encoder(backend="cpu").matrix)
    words, maxj = codec_cuda.gf_terms(REF_MATRIX[10:])
    np.testing.assert_array_equal(state.parity_terms[0], words)
    np.testing.assert_array_equal(state.parity_terms[1], maxj)
    with pytest.raises(ValueError):
        codec_cuda.codec_state_from_numpy(REF_MATRIX[4:])


def test_fused_stages_match_reference_interpret():
    """The port's fused encode/rebuild programs (K1 then K4) on the CPU
    against TpuCodecKernels' fused programs under the Pallas
    interpreter, on the same lanes."""
    ref = ref_codec_tpu.TpuCodecKernels()
    port = codec_cuda.CudaCodecKernels(device="cpu", matrix=ref.matrix)
    data = np.random.default_rng(21).integers(0, 2**32, (10, 256), dtype=np.uint32)
    par, crcs = port.encode_u32_crc(_u32(data))
    rpar, rcrcs = ref.encode_u32_crc(data, interpret=True)
    np.testing.assert_array_equal(par.numpy().view(np.uint32), np.asarray(rpar))
    np.testing.assert_array_equal(crcs.numpy().view(np.uint32), np.asarray(rcrcs))
    shards = np.concatenate([data, np.asarray(rpar)])
    got, gcrcs = port.reconstruct_u32_crc(SURV4, LOST4, _u32(shards[list(SURV4)]))
    want, wcrcs = ref.reconstruct_u32_crc(SURV4, LOST4, shards[list(SURV4)], interpret=True)
    np.testing.assert_array_equal(got.numpy().view(np.uint32), np.asarray(want))
    np.testing.assert_array_equal(gcrcs.numpy().view(np.uint32), np.asarray(wcrcs))
    np.testing.assert_array_equal(got.numpy().view(np.uint32), shards[list(LOST4)])
    np.testing.assert_array_equal(
        port.decode_rows_for(SURV4, LOST4), ref.decode_rows_for(SURV4, LOST4)
    )


def test_plain_versions_do_not_count_as_launches():
    before = (codec_cuda.LAUNCHES.value, crc_kernel.LAUNCHES.value)
    x = _u32(np.ones((10, 64), dtype=np.uint32))
    codec_cuda.gf_apply_u32(MATRICES["parity"], x)
    crc_kernel.crc32c_rows(x)
    assert (codec_cuda.LAUNCHES.value, crc_kernel.LAUNCHES.value) == before


def test_launch_counter_tallies_signatures_and_threads():
    import threading

    from seaweedfs_tpu_torch import _build

    c = _build.LaunchCounter("k")
    c.inc((1, 64))
    c.inc((1, 64))
    c.inc()
    seen = {}

    def other():
        c.inc((4, 8))
        seen["mine"] = c.mine()

    th = threading.Thread(target=other)
    th.start()
    th.join()
    assert c.value == 4
    assert c.by_signature() == {(1, 64): 2, (4, 8): 1}
    assert c.mine() == (3, {(1, 64): 2})  # this thread's own
    assert seen["mine"] == (1, {(4, 8): 1})
    c.reset()
    assert (c.value, c.by_signature()) == (0, {})
    assert c.mine() == (3, {(1, 64): 2})  # read as deltas: reset leaves it


def test_launch_counter_holds_under_contention():
    """More threads than cores bump one counter with a short switch
    interval: no launch is lost from the count, the tally or a thread's
    own count."""
    import sys
    import threading

    from seaweedfs_tpu_torch import _build

    c = _build.LaunchCounter("k")
    threads, per = 4 * (os.cpu_count() or 1) + 1, 500
    mine = [None] * threads

    def bump(t):
        for i in range(per):
            c.inc((t % 3, i % 2))
        mine[t] = c.mine()

    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        ths = [threading.Thread(target=bump, args=(t,)) for t in range(threads)]
        for th in ths:
            th.start()
        for th in ths:
            th.join(60)
    finally:
        sys.setswitchinterval(old)
    assert not any(th.is_alive() for th in ths)
    assert c.value == threads * per
    assert sum(c.by_signature().values()) == threads * per
    assert all(m[0] == per and sum(m[1].values()) == per for m in mine)


def _batch(b: int, n32: int, seed: int) -> np.ndarray:
    return np.random.default_rng(seed).integers(0, 2**32, (b, 10, n32), dtype=np.uint32)


@pytest.mark.parametrize("name", sorted(MATRICES))
@pytest.mark.parametrize("b", [1, 3])
def test_plain_k2_equals_pallas_interpret(name, b):
    rows = MATRICES[name]
    x = _batch(b, 512, b + len(name))
    got = codec_cuda.gf_apply_u32_batch(rows, _u32(x)).numpy().view(np.uint32)
    want = ref_codec_tpu.swar_apply_matrix_u32_batch(rows, x, interpret=True)
    np.testing.assert_array_equal(got, np.asarray(want))
    for v in range(b):
        np.testing.assert_array_equal(
            got[v].view(np.uint8), ref_codec.cpu_apply_matrix(rows, x[v].view(np.uint8))
        )


def test_plain_k3_equals_pallas_interpret():
    rows = MATRICES["parity"]
    x = _batch(4, 512, 7)
    parity = np.stack([ref_codec.cpu_apply_matrix(rows, v.view(np.uint8)) for v in x])
    parity = parity.view(np.uint32).copy()
    parity[1, 0, 5] ^= 1  # one lane
    parity[3, 2, 100] ^= 0x00FF00FF  # two bytes of one lane: still one lane
    parity[3, 3, 511] ^= 1 << 31
    got = codec_cuda.gf_verify_u32_batch(rows, _u32(x), _u32(parity))
    want = ref_codec_tpu.swar_verify_matrix_u32_batch(rows, x, parity, interpret=True)
    assert got.dtype == torch.int32
    assert got.tolist() == np.asarray(want).tolist() == [0, 1, 0, 2]


def test_k2_k3_wrappers_validate_and_write_in_place():
    rows = MATRICES["parity"]
    x = _batch(2, 256, 8)
    tile = torch.zeros((2, 14, 256), dtype=torch.int32)
    tile[:, :10] = _u32(x)
    out = codec_cuda.gf_apply_u32_batch(rows, tile[:, :10], out=tile[:, 10:])
    assert out.data_ptr() == tile[:, 10:].data_ptr()
    want = codec_cuda.gf_apply_batch_plain(rows, _u32(x))
    assert torch.equal(tile[:, 10:], want)
    assert codec_cuda.gf_verify_u32_batch(rows, tile[:, :10], tile[:, 10:]).tolist() == [0, 0]
    with pytest.raises(ValueError):  # k mismatch
        codec_cuda.gf_apply_u32_batch(rows, tile[:, :9])
    with pytest.raises(ValueError):  # lanes not contiguous
        codec_cuda.gf_apply_u32_batch(rows, tile[:, :10, ::2])
    with pytest.raises(ValueError):  # 2-D tile
        codec_cuda.gf_apply_u32_batch(rows, tile[0, :10])
    with pytest.raises(ValueError):  # parity of another width
        codec_cuda.gf_verify_u32_batch(rows, tile[:, :10], tile[:, 10:, :128])


def test_batch_kernels_methods_match_reference_interpret():
    """CudaCodecKernels' batch methods (K2, K3, K4 over [B, rows, n32])
    against TpuCodecKernels' per-volume fused programs under the Pallas
    interpreter."""
    ref = ref_codec_tpu.TpuCodecKernels()
    port = codec_cuda.CudaCodecKernels(device="cpu", matrix=ref.matrix)
    x = _batch(3, 256, 9)
    tile = torch.zeros((3 * 14, 256), dtype=torch.int32)
    data, parity = port.batch_tile_parts(tile)
    assert data.shape == (3, 10, 256) and parity.shape == (3, 4, 256)
    assert data.is_contiguous() and parity.is_contiguous()
    data.copy_(_u32(x))
    crcs = port.encode_batch_tile_crc(tile).numpy().view(np.uint32)
    raw = port.encode_batch_tile_crc(tile.clone(), raw=True)
    np.testing.assert_array_equal(
        crc_kernel.finalize_rows(raw, 1024).numpy().view(np.uint32), crcs
    )
    for v in range(3):
        rpar, rcrcs = ref.encode_u32_crc(x[v], interpret=True)
        np.testing.assert_array_equal(parity[v].numpy().view(np.uint32), np.asarray(rpar))
        np.testing.assert_array_equal(crcs[v], np.asarray(rcrcs))
    shards = torch.cat((data, parity), dim=1).numpy().view(np.uint32)
    got = port.reconstruct_batch_u32(SURV4, LOST4, _u32(shards[:, list(SURV4)]))
    np.testing.assert_array_equal(got.numpy().view(np.uint32), shards[:, list(LOST4)])
    assert port.verify_batch_u32(data, parity).tolist() == [0, 0, 0]
    np.testing.assert_array_equal(port.encode_batch_u32(data), parity)
    with pytest.raises(ValueError):  # not a whole number of volumes
        port.batch_tile_parts(tile[:13])


def test_crc_segments_combine_to_the_whole_row():
    x = np.random.default_rng(10).integers(0, 2**32, (5, 4096), dtype=np.uint32)
    segs = [crc_kernel.crc_lin_rows(_u32(x[:, i : i + 1024])) for i in range(0, 4096, 1024)]
    got = crc_kernel.combine_segments(segs, 4096).numpy().view(np.uint32)
    assert got.tolist() == [ref_crc.crc32c(x[r].tobytes()) for r in range(5)]


def test_crc_span_sweep_needs_a_card(monkeypatch):
    from seaweedfs_tpu_torch import crc_span_sweep

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert crc_span_sweep.main() == 1


def test_crc_span_sweep_keeps_its_own_shapes():
    """The sweep names its shapes itself ([1, 4, 14, 224] rows of 1 MiB)
    and imports nothing of the repo-root chip_smoke."""
    import subprocess
    import sys

    from seaweedfs_tpu_torch import crc_span_sweep

    assert crc_span_sweep.SHAPES == (1, 4, 14, 224)
    assert crc_span_sweep.LANES * 4 == 1 << 20
    code = ("import sys\n"
            "import seaweedfs_tpu_torch.crc_span_sweep as s\n"
            "assert 'chip_smoke' not in sys.modules\n"
            "print('chip_smoke' in open(s.__file__).read())\n")
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    out = subprocess.run([sys.executable, "-c", code], cwd=repo, capture_output=True,
                         text=True, timeout=120)
    assert out.returncode == 0, out.stderr[-2000:]
    assert out.stdout.strip() == "False"
