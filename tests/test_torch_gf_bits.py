"""K5, the GF(2) bit-matrix apply, against seaweedfs_tpu's on the CPU.

The port's plain version of K5 (codec_cuda.gf_bits_plain, which the
wrappers run on a CPU tensor) against the reference's
apply_matrix_bits, apply_matrix_bits_batch and the u32-lane wrappers
under JAX on the CPU, on the same seeded inputs; and the codec backend
`cuda_apply_matrix` on both sides of its 64 KiB split against the
reference's tpu_apply_matrix and the cpu codec. The tolerance is byte
identity. Which plain version served a stream (K5's or K1's) is counted
by wrapping both, which is how the routing is shown without a card.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from seaweedfs_tpu.ec import codec as ref_codec
from seaweedfs_tpu.ec import codec_tpu as ref_tpu
from seaweedfs_tpu_torch.ec import codec_cuda as cc
from seaweedfs_tpu_torch.ec import gf256

ROWS = (1, 2, 4)
COLS = (10, 6)
SIZES = (1, 7, 1024, 4099, 32768, 65535)


def _case(r, c, n, b, seed):
    rng = np.random.default_rng(seed)
    m = rng.integers(0, 256, (r, c), dtype=np.uint8)
    x = rng.integers(0, 256, (b, c, n), dtype=np.uint8)
    return m, x


@pytest.mark.parametrize("r", ROWS)
@pytest.mark.parametrize("c", COLS)
def test_bit_matrix_matches_reference(r, c):
    m, _ = _case(r, c, 1, 1, seed=r * 100 + c)
    a_bits = cc.gf_matrix_to_bits(m)
    np.testing.assert_array_equal(a_bits, ref_tpu.gf_matrix_to_bits(m))
    # K5's mask words hold the same bits, column 8c + j at bit
    # (8c + j) % 32 of word (8c + j) // 32
    masks = cc.bit_masks(a_bits)
    assert masks.shape == (r * 8, 4) and masks.dtype == np.uint32
    for row in range(r * 8):
        for col in range(128):
            bit = (int(masks[row, col // 32]) >> (col % 32)) & 1
            assert bit == (a_bits[row, col] if col < c * 8 else 0)


@pytest.mark.parametrize("n", SIZES)
@pytest.mark.parametrize("c", COLS)
@pytest.mark.parametrize("r", ROWS)
def test_apply_matrix_bits_matches_reference(r, c, n):
    m, x = _case(r, c, n, 1, seed=n + 7 * r + c)
    a_bits = cc.gf_matrix_to_bits(m)
    want = np.asarray(ref_tpu.apply_matrix_bits(jnp.asarray(a_bits), jnp.asarray(x[0])))
    got = cc.apply_matrix_bits(a_bits, torch.from_numpy(x[0]))
    assert got.dtype == torch.uint8 and got.shape == (r, n)
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("b", (1, 3))
@pytest.mark.parametrize("n", (7, 4099))
@pytest.mark.parametrize("c", COLS)
@pytest.mark.parametrize("r", ROWS)
def test_apply_matrix_bits_batch_matches_reference(r, c, n, b):
    m, x = _case(r, c, n, b, seed=1000 + n + r + c + b)
    a_bits = cc.gf_matrix_to_bits(m)
    want = np.asarray(
        ref_tpu.apply_matrix_bits_batch(jnp.asarray(a_bits), jnp.asarray(x))
    )
    got = cc.apply_matrix_bits_batch(a_bits, torch.from_numpy(x))
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("b", (1, 3))
@pytest.mark.parametrize("n32", (1, 1025, 8192))
@pytest.mark.parametrize("r", ROWS)
def test_u32_wrappers_match_reference(r, n32, b):
    m, x = _case(r, 10, n32 * 4, b, seed=2000 + n32 + r + b)
    a_bits = cc.gf_matrix_to_bits(m)
    lanes = np.ascontiguousarray(x).view(np.uint32)  # [b, 10, n32]
    want = np.asarray(
        ref_tpu.apply_matrix_bits_u32_batch(jnp.asarray(a_bits), jnp.asarray(lanes))
    )
    got = cc.apply_matrix_bits_u32_batch(
        a_bits, torch.from_numpy(lanes.view(np.int32))
    )
    np.testing.assert_array_equal(got.numpy().view(np.uint32), want)
    want1 = np.asarray(
        ref_tpu.apply_matrix_bits_u32(jnp.asarray(a_bits), jnp.asarray(lanes[0]))
    )
    got1 = cc.apply_matrix_bits_u32(a_bits, torch.from_numpy(lanes[0].view(np.int32)))
    np.testing.assert_array_equal(got1.numpy().view(np.uint32), want1)
    # K5 on lanes equals K1's plain version on the same lanes
    k1 = cc.gf_apply_plain(m, torch.from_numpy(lanes[0].view(np.int32)))
    np.testing.assert_array_equal(got1.numpy(), k1.numpy())


def test_wrappers_refuse_bad_shapes():
    a_bits = cc.gf_matrix_to_bits(np.ones((2, 10), np.uint8))
    with pytest.raises(ValueError):
        cc.apply_matrix_bits(a_bits, torch.zeros((6, 8), dtype=torch.uint8))
    with pytest.raises(ValueError):
        cc.apply_matrix_bits_batch(a_bits, torch.zeros((1, 10, 8), dtype=torch.int32))
    with pytest.raises(ValueError):
        cc.apply_matrix_bits_u32(a_bits, torch.zeros((10, 2), dtype=torch.uint8))


@pytest.fixture
def routed(monkeypatch):
    """Counts of the plain versions that served: K5's and K1's."""
    counts = {"k5": 0, "k1": 0}
    k5, k1 = cc.gf_bits_plain, cc.gf_apply_plain

    def count_k5(*a, **kw):
        counts["k5"] += 1
        return k5(*a, **kw)

    def count_k1(*a, **kw):
        counts["k1"] += 1
        return k1(*a, **kw)

    monkeypatch.setattr(cc, "gf_bits_plain", count_k5)
    monkeypatch.setattr(cc, "gf_apply_plain", count_k1)
    return counts


# sizes around the split: buckets of 1, 4, 32 KiB take K5, 64 and
# 128 KiB K1 (the bucket of 32769..65536 bytes is 64 KiB)
@pytest.mark.parametrize(
    "n, route",
    [(100, "k5"), (4099, "k5"), (32768, "k5"), (32769, "k1"), (65536, "k1"),
     (65537, "k1")],
)
def test_cuda_apply_matrix_splits_at_64k(routed, n, route):
    rng = np.random.default_rng(n)
    # a degraded read's decode rows: shards 0 and 5 from ten survivors
    survivors = (1, 2, 3, 4, 6, 7, 8, 9, 11, 12)
    m = gf256.decode_rows(gf256.build_code_matrix(10, 14), survivors, (0, 5))
    x = rng.integers(0, 256, (10, n), dtype=np.uint8)
    got = cc.cuda_apply_matrix(m, x, device="cpu")
    np.testing.assert_array_equal(got, ref_tpu.tpu_apply_matrix(m, x))
    np.testing.assert_array_equal(got, ref_codec.cpu_apply_matrix(m, x))
    assert routed == {"k5": int(route == "k5"), "k1": int(route == "k1")}
