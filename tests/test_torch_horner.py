"""The CUDA kernels' matrix argument against the reference's Pallas
kernel, on the CPU.

K1/K2/K3 (csrc/gf_swar.cuh) take a GF matrix as one 0-or-all-ones word
per (row, bit, column) plus a Horner start per row (codec_cuda.gf_terms)
and evaluate each row branch-free: enter at bit maxj[p], then for every
lower bit double and XOR in `x[c] & word`. A numpy model of exactly that
chain, fed the host-built words, is held against
seaweedfs_tpu.ec.codec_tpu.swar_apply_u32 in interpret mode on the same
seeded lanes; the model is the kernel's arithmetic, so this holds the
argument layout and the Horner entry against the reference. Tolerance 0
(integer GF(2^8) math).
"""

import numpy as np
import pytest

from seaweedfs_tpu.ec import codec_tpu as ref_codec_tpu
from seaweedfs_tpu_torch.ec import codec_cuda

N32 = 256


def _double4(y: np.ndarray) -> np.ndarray:
    """gf_double4: four packed GF(2^8) bytes times 2, polynomial 0x11D."""
    hb = y & np.uint32(0x80808080)
    return ((y << np.uint32(1)) & np.uint32(0xFEFEFEFE)) ^ ((hb >> np.uint32(7)) * np.uint32(0x1D))


def kernel_model(words: np.ndarray, maxj: np.ndarray, x: np.ndarray) -> np.ndarray:
    """gf_row over every output row: y = 0, the switch enters at bit
    maxj[p], the step at bit 7 skips its doubling, every lower step
    doubles, and each step XORs x[c] & words[p, j, c] for every c."""
    r, _, k = words.shape
    out = np.zeros((r, x.shape[1]), dtype=np.uint32)
    for p in range(r):
        y = np.zeros(x.shape[1], dtype=np.uint32)
        for j in range(int(maxj[p]), -1, -1):
            if j < 7:
                y = _double4(y)
            for c in range(k):
                y ^= x[c] & words[p, j, c]
        out[p] = y
    return out


def _rows(r: int, k: int, seed: int) -> np.ndarray:
    rng = np.random.default_rng(seed)
    rows = rng.integers(0, 256, (r, k), dtype=np.uint8)
    rows[rng.random((r, k)) < 0.25] = 0
    rows[0] &= 0x3F  # a row whose Horner chain starts below bit 7
    if r > 1:
        rows[-1] = 0  # an all-zero row: maxj 0, every word 0
    return rows


@pytest.mark.parametrize("r", [1, 4, 16])
@pytest.mark.parametrize("k", [1, 7, 10, 16])
def test_branch_free_horner_equals_pallas_interpret(k, r):
    rows = _rows(r, k, 31 * k + r)
    x = np.random.default_rng(k * r).integers(0, 2**32, (k, N32), dtype=np.uint32)
    words, maxj = codec_cuda.gf_terms(rows)
    want = ref_codec_tpu.swar_apply_u32(
        x, tn=N32, r_out=r, k=k, rows_tuple=tuple(int(v) for v in rows.reshape(-1)),
        interpret=True,
    )
    np.testing.assert_array_equal(kernel_model(words, maxj, x), np.asarray(want))
