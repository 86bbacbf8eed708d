"""K5's tensor-core arm emulated on the CPU, lane by lane.

csrc/gf_bits.cu runs the GF(2) bit-matrix product as warp-wide mma
instructions whose operands are fragment registers spread over the 32
lanes. Here numpy plays the warp: each lane (g = lane // 4, t = lane % 4)
reads input rows t, t+4, t+8, t+12 at its 4 byte columns of a 32-column
chunk, transposes them with __byte_perm's selectors, and the fragments
are assembled into the mma's A and B matrices by the PTX ISA's fragment
layout of m16n8k128 .b1, multiplied (AND, popcount), scattered back to
the lanes by the accumulator layout and repacked by the kernel's shifts
and shuffles. The B fragments are codec_cuda.bit_frags, the host packing
the kernel takes. The result is held against seaweedfs_tpu's
apply_matrix_bits under JAX on the CPU, for seeded random (R, C, n) with
R, C in 1..16; it is exact, so the tolerance is 0. The dispatch rule,
which the wrapper applies in Python, is checked here too.
"""

import jax.numpy as jnp
import numpy as np
import pytest

from seaweedfs_tpu.ec import codec_tpu as ref_tpu
from seaweedfs_tpu_torch.ec import codec_cuda as cc

U32 = np.uint64(0xFFFFFFFF)


def _byte_perm(x, y, sel: int):
    """CUDA's __byte_perm: byte i of the result is byte (sel >> 4i) & 7
    of the 8 bytes {y, x} (x the low four)."""
    both = (y.astype(np.uint64) << np.uint64(32)) | x.astype(np.uint64)
    out = np.zeros_like(both)
    for i in range(4):
        src = (sel >> (4 * i)) & 7
        out |= ((both >> np.uint64(8 * src)) & np.uint64(0xFF)) << np.uint64(8 * i)
    return out.astype(np.uint32)


def _transpose(w):
    """gb_transpose: byte q of w[t] -> byte t of v[q]."""
    lo01 = _byte_perm(w[0], w[1], 0x5140)
    lo23 = _byte_perm(w[2], w[3], 0x5140)
    hi01 = _byte_perm(w[0], w[1], 0x7362)
    hi23 = _byte_perm(w[2], w[3], 0x7362)
    return [_byte_perm(lo01, lo23, 0x5410), _byte_perm(lo01, lo23, 0x7632),
            _byte_perm(hi01, hi23, 0x5410), _byte_perm(hi01, hi23, 0x7632)]


def _bits(w, count: int):
    """[..., count] 0/1: bit i of w at index i."""
    return ((w[..., None].astype(np.uint64) >> np.arange(count, dtype=np.uint64)) & 1).astype(
        np.int64)


G = np.arange(32) // 4
T = np.arange(32) % 4


def _mma_b1(a0, a1, b):
    """mma.m16n8k128.row.col.s32.b1.b1.s32.and.popc over [chunks, 32]
    registers: A row g (a0) / g+8 (a1), k = 32t + i at bit i; B column
    g, k = 32t + i at bit i. Returns the lanes' d0..d3: D[g][2t],
    D[g][2t+1], D[g+8][2t], D[g+8][2t+1]."""
    ch = a0.shape[0]
    a = np.zeros((ch, 16, 128), np.int64)
    bm = np.zeros((ch, 128, 8), np.int64)
    for lane in range(32):
        g, t = G[lane], T[lane]
        a[:, g, 32 * t:32 * t + 32] = _bits(a0[:, lane], 32)
        a[:, g + 8, 32 * t:32 * t + 32] = _bits(a1[:, lane], 32)
        bm[:, 32 * t:32 * t + 32, g] = _bits(b[:, lane], 32)
    return _scatter(a @ bm)


def _scatter(d):
    """The accumulator layout: lane (g, t) holds D[g][2t], D[g][2t+1],
    D[g+8][2t], D[g+8][2t+1]."""
    return [d[:, G, 2 * T], d[:, G, 2 * T + 1], d[:, G + 8, 2 * T], d[:, G + 8, 2 * T + 1]]


def emulate(frags: np.ndarray, x: np.ndarray) -> np.ndarray:
    """[C, n] uint8 (n a multiple of 4) -> [R, n] uint8, the way the
    warps of gf_bits_mma_kernel compute it, chunk by chunk: a lane past n
    loads zeros and stores nothing."""
    c, n = x.shape
    r = frags.shape[0]
    ch = -(-n // 32)
    rows16 = np.zeros((16, 32 * ch), np.uint8)
    rows16[:c, :n] = x
    cb = 32 * np.arange(ch)[:, None] + 4 * G[None, :]  # [chunks, lanes]
    w = []
    for q in range(4):  # input row 4q + t at the lane's 4 columns, little-endian
        cols = cb[:, :, None] + np.arange(4)
        by = rows16[(4 * q + T)[None, :, None], cols].astype(np.uint32)
        w.append((by << (8 * np.arange(4, dtype=np.uint32))).sum(axis=2, dtype=np.uint32))
    v = _transpose(w)  # v[p]: column cb + p, byte q = input row 4q + t
    out = np.zeros((r, 32 * ch), np.uint8)
    for row in range(r):
        f = np.broadcast_to(frags[row], (ch, 32)).astype(np.uint32)
        d = [_mma_b1(v[2 * h], v[2 * h + 1], f) for h in range(2)]
        word = np.zeros((ch, 32), np.uint64)
        for h in range(2):
            word |= ((d[h][0] & 1) | (d[h][1] & 1) << 1 | (d[h][2] & 1) << 8
                     | (d[h][3] & 1) << 9).astype(np.uint64) << np.uint64(16 * h)
        word = (word << (2 * T).astype(np.uint64)) & U32
        for lane_xor in (1, 2):  # __shfl_xor_sync, OR-reduced
            word = word | word[:, np.arange(32) ^ lane_xor]
        for lane in range(0, 32, 4):  # lane t == 0 of each group stores 4 columns
            for p in range(4):
                out[row, cb[:, lane] + p] = (word[:, lane] >> np.uint64(8 * p)) & np.uint64(0xFF)
    return out[:, :n]


def _draws(count: int, seed: int):
    rng = np.random.default_rng(seed)
    cases = []
    for i in range(count):
        r, c = int(rng.integers(1, 17)), int(rng.integers(1, 17))
        if i < 4:  # the corners: 1 and 16 rows and columns
            r, c = (1, 16, 1, 16)[i], (1, 1, 16, 16)[i]
        cases.append((r, c, 4 * int(rng.integers(1, 40)), int(rng.integers(0, 2**31))))
    return cases


@pytest.mark.parametrize("r, c, n, seed", _draws(20, 10))
def test_warp_emulation_equals_reference(r, c, n, seed):
    rng = np.random.default_rng(seed)
    m = rng.integers(0, 256, (r, c), dtype=np.uint8)
    x = rng.integers(0, 256, (c, n), dtype=np.uint8)
    a_bits = cc.gf_matrix_to_bits(m)
    want = np.asarray(ref_tpu.apply_matrix_bits(jnp.asarray(a_bits), jnp.asarray(x)))
    got = emulate(cc.bit_frags(a_bits), x)
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("r, c", [(1, 10), (4, 10), (16, 16), (3, 1), (2, 7)])
def test_fragments_carry_the_masks_bits(r, c):
    """bit_frags holds exactly the bits of bit_masks, lane 4g + t's bit
    8q + j being mask row 8r + g's column 8(4q + t) + j."""
    a_bits = cc.gf_matrix_to_bits(np.random.default_rng(r * 17 + c).integers(
        0, 256, (r, c), dtype=np.uint8))
    masks, frags = cc.bit_masks(a_bits), cc.bit_frags(a_bits)
    assert frags.shape == (r, 32) and frags.dtype == np.uint32
    for row in range(r):
        for lane in range(32):
            g, t = divmod(lane, 4)
            for q in range(4):
                for j in range(8):
                    col = 8 * (4 * q + t) + j
                    want = (int(masks[8 * row + g, col // 32]) >> (col % 32)) & 1
                    assert (int(frags[row, lane]) >> (8 * q + j)) & 1 == want
    assert cc.bit_args(a_bits).frags.tobytes() == frags.tobytes()


@pytest.mark.parametrize(
    "in_ptr, out_ptr, n, mma",
    [(0x7F0000000000, 0x7F0000100000, 32768, True),
     (0x7F0000000000, 0x7F0000100000, 1024, True),
     (0x7F0000000008, 0x7F0000100004, 20, True),
     (0x7F0000000001, 0x7F0000100000, 4096, False),
     (0x7F0000000000, 0x7F0000100002, 4096, False),
     (0x7F0000000000, 0x7F0000100000, 4099, False),
     (0x7F0000000000, 0x7F0000100000, 48, True)],
)
def test_dispatch_is_by_shape(in_ptr, out_ptr, n, mma):
    """The tensor-core arm takes rows that start on 4 bytes, at any batch
    size, the ALU arm the rest."""
    assert cc.k5_takes_mma(in_ptr, out_ptr, n) is mma
