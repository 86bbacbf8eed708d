"""CUDA backend of the RS codec: the GF(2^8) matrix apply (K1), its
batched form (K2), the fused parity verify (K3) and the GF(2)
bit-matrix apply (K5) that serves streams under 64 KiB.

The counterpart of seaweedfs_tpu/ec/codec_tpu.py. Streams are u32
lanes (4 stream bytes per lane, little-endian: numpy
``.view(np.uint32)``) carried in int32 tensors. On a CUDA tensor
`gf_apply_u32` and `gf_apply_u32_batch` launch csrc/gf_apply.cu, and
`gf_verify_u32_batch` launches csrc/gf_verify.cu (see their headers and
csrc/gf_swar.cuh for the design and bound: the coefficient matrix is a
per-launch argument of one 0-or-all-ones word per (row, bit, column),
gf_terms, so one compiled kernel per column count serves encode and
every decode matrix, at any lane count). On a CPU tensor each runs its
plain version below: a byte-level MUL-table gather, independent of the
SWAR arithmetic the kernels use.

Encode uses the parity rows of the code matrix; reconstruct uses rows
from gf256.decode_rows (the survivor-matrix inversion stays on the
host). `cuda_apply_matrix`, the codec backend, splits streams as the
reference's tpu_apply_matrix does: a size bucket under 64 KiB takes K5
(`apply_matrix_bits`, csrc/gf_bits.cu), a larger one K1.
"""

from __future__ import annotations

import ctypes
import threading
from dataclasses import dataclass, field
from typing import NamedTuple

import numpy as np
import torch

from seaweedfs_tpu_torch import _build
from seaweedfs_tpu_torch.ec import crc_kernel, gf256
from seaweedfs_tpu_torch.ec.codec import register_backend

LAUNCHES = _build.LaunchCounter("gf_apply")
BATCH_LAUNCHES = _build.LaunchCounter("gf_apply_batch")
VERIFY_LAUNCHES = _build.LaunchCounter("gf_verify_batch")
BITS_LAUNCHES = _build.LaunchCounter("gf_bits")  # K5, both arms, by signature
BITS_MMA_LAUNCHES = _build.LaunchCounter("gf_bits_mma")  # K5's tensor-core arm
BITS_ALU_LAUNCHES = _build.LaunchCounter("gf_bits_alu")  # K5's ALU arm
_MAX_K = 16  # csrc/gf_swar.cuh GF_MAX_K / GF_MAX_ROWS
_MAX_ROWS = 16


def gf_terms(rows: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """The kernels' matrix argument for GF coefficient rows [r, k]:
    words [r, 8, k] uint32, 0xFFFFFFFF where rows[p, c] has bit j and 0
    elsewhere (a Horner term is then `y ^= x[c] & words[p, j, c]`), and
    maxj [r] int32, the highest j with a nonzero word (Horner start)."""
    rows = np.asarray(rows, dtype=np.uint8)
    bits = (rows[:, None, :] >> np.arange(8, dtype=np.uint8)[None, :, None]) & 1
    words = bits.astype(np.uint32) * np.uint32(0xFFFFFFFF)  # [r, 8, k]
    nonempty = bits.any(axis=2)  # [r, 8]
    maxj = np.where(
        nonempty.any(axis=1), 7 - np.argmax(nonempty[:, ::-1], axis=1), 0
    ).astype(np.int32)
    return np.ascontiguousarray(words), np.ascontiguousarray(maxj)


# --- plain version ----------------------------------------------------------

_MUL_CACHE: dict[torch.device, torch.Tensor] = {}
_mul_lock = threading.Lock()


def _mul_table(device: torch.device) -> torch.Tensor:
    with _mul_lock:
        t = _MUL_CACHE.get(device)
        if t is None:
            t = _MUL_CACHE[device] = torch.from_numpy(gf256.MUL_TABLE).to(device)
        return t


def gf_apply_plain(rows: np.ndarray, x_u32: torch.Tensor) -> torch.Tensor:
    """[k, n32] int32 lanes -> [r, n32] int32: out[p] = XOR_c
    MUL[rows[p, c]][x[c]] over the bytes of the lanes."""
    rows = np.asarray(rows, dtype=np.uint8)
    k, n32 = x_u32.shape
    mul = _mul_table(x_u32.device)
    xb = x_u32.contiguous().view(torch.uint8).reshape(k, n32 * 4).long()
    out = torch.zeros((rows.shape[0], n32 * 4), dtype=torch.uint8, device=x_u32.device)
    for p in range(rows.shape[0]):
        for c in range(k):
            coef = int(rows[p, c])
            if coef:
                out[p] ^= mul[coef][xb[c]]
    return out.view(torch.int32)


def gf_apply_batch_plain(rows: np.ndarray, x_u32: torch.Tensor) -> torch.Tensor:
    """[B, k, n32] int32 lanes -> [B, r, n32]: gf_apply_plain over the
    volumes laid side by side (GF math is positionwise)."""
    b, k, n32 = x_u32.shape
    r = np.asarray(rows).shape[0]
    flat = x_u32.transpose(0, 1).reshape(k, b * n32)
    return gf_apply_plain(rows, flat).reshape(r, b, n32).transpose(0, 1).contiguous()


def gf_verify_batch_plain(
    rows: np.ndarray, x_u32: torch.Tensor, parity_u32: torch.Tensor
) -> torch.Tensor:
    """[B] int32: per volume, the (parity row, u32 lane) pairs where the
    parity recomputed from x differs from the given one."""
    diff = gf_apply_batch_plain(rows, x_u32) != parity_u32
    return diff.sum(dim=(1, 2)).to(torch.int32)


# --- kernel wrappers --------------------------------------------------------

_lib_lock = threading.Lock()
_libs: dict[str, ctypes.CDLL] = {}
_I64, _PTR = ctypes.c_longlong, ctypes.c_void_p
_ARGTYPES = {
    "gf_apply.cu": {
        "gf_apply_u32": (_PTR, _PTR, _I64, _I64, _I64, _PTR, _PTR, _PTR),
        "gf_apply_u32_batch": (
            _PTR, _PTR, _I64, _I64, _I64, _I64, _I64, _I64, _PTR, _PTR, _PTR,
        ),
    },
    "gf_bits.cu": {
        "gf_bits_apply": (
            _PTR, _PTR, _I64, _I64, _I64, _I64, _I64, _I64, _PTR, _PTR,
        ),
        "gf_bits_apply_mma": (
            _PTR, _PTR, _I64, _I64, _I64, _I64, _I64, _I64, _PTR, _PTR,
        ),
    },
    "gf_verify.cu": {
        "gf_verify_u32_batch": (
            _PTR, _PTR, _PTR, _I64, _I64, _I64, _I64, _I64, _I64, _PTR, _PTR,
            _PTR,
        ),
    },
}


def _kernel(src: str = "gf_apply.cu"):
    with _lib_lock:
        lib = _libs.get(src)
        if lib is None:
            lib = _build.load(src)
            for name, argtypes in _ARGTYPES[src].items():
                fn = getattr(lib, name)
                fn.restype = ctypes.c_int
                fn.argtypes = argtypes
            _libs[src] = lib
        return lib


def gf_apply_u32(
    rows: np.ndarray,
    x_u32: torch.Tensor,
    terms: tuple[np.ndarray, np.ndarray] | None = None,
    out: torch.Tensor | None = None,
) -> torch.Tensor:
    """[k, n32] int32 lanes -> [r, n32] int32 lanes of GF(2^8) products
    with coefficient rows [r, k]. Launches K1 on a CUDA tensor (current
    stream; `terms` is gf_terms(rows), precomputed by callers that
    reuse a matrix; `out` an optional preallocated [r, n32] result);
    runs the plain version on a CPU tensor."""
    rows = np.asarray(rows, dtype=np.uint8)
    r, k = rows.shape
    if x_u32.dtype != torch.int32 or x_u32.dim() != 2 or x_u32.shape[0] != k:
        raise ValueError(
            f"gf_apply_u32 takes [{k}, n32] int32 lanes, got "
            f"{tuple(x_u32.shape)} {x_u32.dtype}"
        )
    if not x_u32.is_cuda:
        if x_u32.device.type != "cpu":
            raise ValueError(f"gf_apply_u32: unsupported device {x_u32.device}")
        got = gf_apply_plain(rows, x_u32)
        if out is not None:
            out.copy_(got)
            return out
        return got
    if not 1 <= k <= _MAX_K or not 1 <= r <= _MAX_ROWS:
        raise ValueError(f"gf_apply_u32 takes at most {_MAX_K}x{_MAX_ROWS} matrices")
    if not x_u32.is_contiguous() or x_u32.shape[1] < 1:
        raise ValueError("gf_apply_u32 takes a contiguous, nonempty tile")
    n32 = x_u32.shape[1]
    if out is None:
        out = torch.empty((r, n32), dtype=torch.int32, device=x_u32.device)
    elif (
        out.shape != (r, n32)
        or out.dtype != torch.int32
        or out.device != x_u32.device
        or not out.is_contiguous()
    ):
        raise ValueError("gf_apply_u32: out must be a contiguous [r, n32] int32 tensor")
    w, mj = terms if terms is not None else gf_terms(rows)
    lib = _kernel()
    stream = torch.cuda.current_stream(x_u32.device).cuda_stream
    err = lib.gf_apply_u32(
        x_u32.data_ptr(), out.data_ptr(), k, r, n32,
        w.ctypes.data, mj.ctypes.data, stream,
    )
    _build.check(err, "gf_apply launch")
    LAUNCHES.inc((r, k, n32, rows.tobytes()))
    return out


def _check_batch(x: torch.Tensor, rows: int, n32: int | None, what: str) -> None:
    """A [B, rows, n32] int32 lane batch the batch kernels take: lanes
    contiguous, rows of a volume n32 lanes apart, any volume stride."""
    if x.dtype != torch.int32 or x.dim() != 3 or x.shape[1] != rows:
        raise ValueError(
            f"{what} takes [B, {rows}, n32] int32 lanes, got "
            f"{tuple(x.shape)} {x.dtype}"
        )
    if n32 is not None and x.shape[2] != n32:
        raise ValueError(f"{what}: {x.shape[2]} lanes, expected {n32}")
    if x.shape[2] < 1 or x.stride(2) != 1 or x.stride(1) != x.shape[2]:
        raise ValueError(
            f"{what}: lanes must be contiguous and rows n32 lanes apart"
        )


def gf_apply_u32_batch(
    rows: np.ndarray,
    x_u32: torch.Tensor,
    terms: tuple[np.ndarray, np.ndarray] | None = None,
    out: torch.Tensor | None = None,
) -> torch.Tensor:
    """[B, k, n32] int32 lanes -> [B, r, n32]: gf_apply_u32 over a batch
    of volumes. Launches K2 once for the whole batch on a CUDA tensor
    (current stream; `out` may be a view such as the parity rows of a
    [B, k + r, n32] tile, written in place); runs the plain version on a
    CPU tensor."""
    rows = np.asarray(rows, dtype=np.uint8)
    r, k = rows.shape
    _check_batch(x_u32, k, None, "gf_apply_u32_batch")
    b, _, n32 = x_u32.shape
    if out is not None:
        _check_batch(out, r, n32, "gf_apply_u32_batch out")
        if out.shape[0] != b or out.device != x_u32.device:
            raise ValueError("gf_apply_u32_batch: out must match the batch")
    if not x_u32.is_cuda:
        if x_u32.device.type != "cpu":
            raise ValueError(f"gf_apply_u32_batch: unsupported device {x_u32.device}")
        got = gf_apply_batch_plain(rows, x_u32)
        if out is not None:
            out.copy_(got)
            return out
        return got
    if not 1 <= k <= _MAX_K or not 1 <= r <= _MAX_ROWS:
        raise ValueError(f"gf_apply_u32_batch takes at most {_MAX_K}x{_MAX_ROWS} matrices")
    if out is None:
        out = torch.empty((b, r, n32), dtype=torch.int32, device=x_u32.device)
    if b == 0:
        return out
    w, mj = terms if terms is not None else gf_terms(rows)
    lib = _kernel()
    stream = torch.cuda.current_stream(x_u32.device).cuda_stream
    err = lib.gf_apply_u32_batch(
        x_u32.data_ptr(), out.data_ptr(), b, k, r, n32, x_u32.stride(0),
        out.stride(0), w.ctypes.data, mj.ctypes.data, stream,
    )
    _build.check(err, "gf_apply_batch launch")
    BATCH_LAUNCHES.inc()
    return out


def gf_verify_u32_batch(
    rows: np.ndarray,
    x_u32: torch.Tensor,
    parity_u32: torch.Tensor,
    terms: tuple[np.ndarray, np.ndarray] | None = None,
) -> torch.Tensor:
    """Data [B, k, n32] + parity [B, r, n32] int32 lanes -> [B] int32
    counts of mismatched (parity row, u32 lane) pairs, 0 = verified,
    without materialising the recomputed parity. Launches K3 on CUDA
    tensors (current stream); runs the plain version on CPU tensors."""
    rows = np.asarray(rows, dtype=np.uint8)
    r, k = rows.shape
    _check_batch(x_u32, k, None, "gf_verify_u32_batch")
    b, _, n32 = x_u32.shape
    _check_batch(parity_u32, r, n32, "gf_verify_u32_batch parity")
    if parity_u32.shape[0] != b or parity_u32.device != x_u32.device:
        raise ValueError("gf_verify_u32_batch: parity must match the batch")
    if not x_u32.is_cuda:
        if x_u32.device.type != "cpu":
            raise ValueError(f"gf_verify_u32_batch: unsupported device {x_u32.device}")
        return gf_verify_batch_plain(rows, x_u32, parity_u32)
    if not 1 <= k <= _MAX_K or not 1 <= r <= _MAX_ROWS:
        raise ValueError(f"gf_verify_u32_batch takes at most {_MAX_K}x{_MAX_ROWS} matrices")
    if r * n32 >= 2**31:
        raise ValueError("gf_verify_u32_batch: a volume's count would overflow int32")
    counts = torch.empty(b, dtype=torch.int32, device=x_u32.device)
    if b == 0:
        return counts
    w, mj = terms if terms is not None else gf_terms(rows)
    lib = _kernel("gf_verify.cu")
    stream = torch.cuda.current_stream(x_u32.device).cuda_stream
    err = lib.gf_verify_u32_batch(
        x_u32.data_ptr(), parity_u32.data_ptr(), counts.data_ptr(), b, k, r,
        n32, x_u32.stride(0), parity_u32.stride(0), w.ctypes.data,
        mj.ctypes.data, stream,
    )
    _build.check(err, "gf_verify_batch launch")
    VERIFY_LAUNCHES.inc()
    return counts


# --- K5: GF(2) bit-matrix apply --------------------------------------------

# Streams whose size bucket is under this take K5, larger ones K1: the
# split of the reference's tpu_apply_matrix (codec_tpu._SWAR_MIN_BYTES).
SWAR_MIN_BYTES = 64 * 1024


def gf_matrix_to_bits(matrix: np.ndarray) -> np.ndarray:
    """Expand a GF(2^8) coefficient matrix [R, C] to its GF(2)
    bit-matrix [R*8, C*8] int8 of 8x8 blocks B(m[r, c]), B(c)[i, j] =
    bit i of c * 2^j (codec_tpu.gf_matrix_to_bits)."""
    matrix = np.asarray(matrix, dtype=np.uint8)
    r, c = matrix.shape
    pow2 = (1 << np.arange(8)).astype(np.uint8)
    prods = gf256.MUL_TABLE[matrix.reshape(-1)[:, None], pow2[None, :]]
    bits = (prods[None, :, :] >> np.arange(8)[:, None, None]) & 1  # [8, R*C, 8]
    blocks = bits.transpose(1, 0, 2).reshape(r, c, 8, 8)  # [R, C, i, j]
    return blocks.transpose(0, 2, 1, 3).reshape(r * 8, c * 8).astype(np.int8)


def bit_masks(a_bits: np.ndarray) -> np.ndarray:
    """K5's ALU arm's matrix argument: each bit-matrix row as 4 uint32
    words, column 8c + j at bit (8c + j) % 32 of word (8c + j) // 32
    ([R*8, 4] uint32; columns past C*8 are 0)."""
    a_bits = np.asarray(a_bits, dtype=np.int8)
    r8, c8 = a_bits.shape
    padded = np.zeros((r8, 128), dtype=np.uint8)
    padded[:, :c8] = a_bits & 1
    return np.ascontiguousarray(
        np.packbits(padded, axis=1, bitorder="little").view("<u4")
    ).astype(np.uint32)


def bit_frags(a_bits: np.ndarray) -> np.ndarray:
    """K5's tensor-core arm's matrix argument, in the order the warps
    read it: the B fragment word of each (output row r, lane 4g + t),
    bit 8q + j = A[8r + g][8(4q + t) + j], i.e. output bit g of row r
    against bit j of input row 4q + t ([R, 32] uint32; rows past C are
    0). csrc/gf_bits.cu's note gives the layout."""
    a_bits = np.asarray(a_bits, dtype=np.int8)
    r8, c8 = a_bits.shape
    padded = np.zeros((r8, 128), dtype=np.uint8)
    padded[:, :c8] = a_bits & 1
    # column 8c + j with c = 4q + t: [r, g, q, t, j] -> [r, g, t, q, j]
    lanes = padded.reshape(r8 // 8, 8, 4, 4, 8).transpose(0, 1, 3, 2, 4)
    words = np.packbits(lanes.reshape(r8 // 8, 32, 32), axis=2, bitorder="little")
    return np.ascontiguousarray(words.view("<u4").reshape(r8 // 8, 32)).astype(np.uint32)


class BitArgs(NamedTuple):
    """K5's matrix argument for both arms, built once per matrix."""

    masks: np.ndarray  # bit_masks: the ALU arm's
    frags: np.ndarray  # bit_frags: the tensor-core arm's


def bit_args(a_bits: np.ndarray) -> BitArgs:
    return BitArgs(bit_masks(a_bits), bit_frags(a_bits))


K5_GRANULE = 4  # the tensor-core arm's word loads and stores
K5_GRID_Y = 65535  # batch items a tensor-core launch takes (the grid's y)


def k5_takes_mma(in_ptr: int, out_ptr: int, n: int) -> bool:
    """K5's dispatch, by shape only: the tensor-core arm takes 4-byte
    aligned input and output with n a multiple of 4 (every row and batch
    item then starts on 4 bytes); the ALU arm takes the rest."""
    return in_ptr % K5_GRANULE == 0 and out_ptr % K5_GRANULE == 0 and n % K5_GRANULE == 0


def _check_bits(a_bits: np.ndarray, cols: int, what: str) -> tuple[int, int]:
    a_bits = np.asarray(a_bits)
    r8, c8 = a_bits.shape
    if r8 % 8 or c8 != cols * 8:
        raise ValueError(
            f"{what}: bit-matrix {a_bits.shape} does not fit {cols} input rows"
        )
    return r8 // 8, cols


def gf_bits_plain(a_bits: np.ndarray, x: torch.Tensor) -> torch.Tensor:
    """[B, C, N] uint8 -> [B, R, N] uint8: unpack LSB-first bit-planes,
    one float32 product with the bit-matrix (exact: a sum is at most
    C*8 <= 128), & 1, pack."""
    b, c, n = x.shape
    r, _ = _check_bits(a_bits, c, "gf_bits_plain")
    shifts = torch.arange(8, dtype=torch.uint8, device=x.device)
    planes = ((x[:, :, None, :] >> shifts[None, None, :, None]) & 1).reshape(b, c * 8, n)
    a = torch.from_numpy(np.asarray(a_bits, dtype=np.float32)).to(x.device)
    acc = torch.matmul(a, planes.to(torch.float32)).to(torch.int32) & 1
    weights = (1 << torch.arange(8, dtype=torch.int32, device=x.device))[None, None, :, None]
    return (acc.reshape(b, r, 8, n) * weights).sum(dim=2).to(torch.uint8)


def apply_matrix_bits_batch(
    a_bits: np.ndarray, inputs: torch.Tensor, args: BitArgs | None = None
) -> torch.Tensor:
    """[B, C, N] uint8 -> [B, R, N] uint8, out[b][r] = XOR_c M[r, c] *
    inputs[b][c] with `a_bits` = gf_matrix_to_bits(M). Launches K5 on a
    CUDA tensor (current stream), on the arm k5_takes_mma picks: once
    for the batch, or on the tensor-core arm once for each K5_GRID_Y
    items. `args` is bit_args(a_bits), precomputed by callers that
    reuse a matrix. Runs the plain version on a CPU tensor."""
    if inputs.dtype != torch.uint8 or inputs.dim() != 3:
        raise ValueError(
            f"apply_matrix_bits takes [B, C, N] uint8, got "
            f"{tuple(inputs.shape)} {inputs.dtype}"
        )
    b, c, n = inputs.shape
    r, _ = _check_bits(a_bits, c, "apply_matrix_bits")
    if not inputs.is_cuda:
        if inputs.device.type != "cpu":
            raise ValueError(f"apply_matrix_bits: unsupported device {inputs.device}")
        return gf_bits_plain(a_bits, inputs)
    if not 1 <= c <= _MAX_K or not 1 <= r <= _MAX_ROWS:
        raise ValueError(f"apply_matrix_bits takes at most {_MAX_K}x{_MAX_ROWS} matrices")
    out = torch.empty((b, r, n), dtype=torch.uint8, device=inputs.device)
    if b == 0 or n == 0:
        return out
    x = inputs.contiguous()
    lib = _kernel("gf_bits.cu")
    stream = torch.cuda.current_stream(x.device).cuda_stream
    key = np.asarray(a_bits, dtype=np.int8).tobytes()
    if k5_takes_mma(x.data_ptr(), out.data_ptr(), n):
        frags = args.frags if args is not None else bit_frags(a_bits)
        for b0 in range(0, b, K5_GRID_Y):
            part = min(K5_GRID_Y, b - b0)
            err = lib.gf_bits_apply_mma(
                x.data_ptr() + b0 * c * n, out.data_ptr() + b0 * r * n, part, c, r, n,
                c * n, r * n, frags.ctypes.data, stream,
            )
            _build.check(err, "gf_bits (tensor-core arm) launch")
            BITS_MMA_LAUNCHES.inc()
            BITS_LAUNCHES.inc((r, c, n, part, key))
    else:
        masks = args.masks if args is not None else bit_masks(a_bits)
        err = lib.gf_bits_apply(
            x.data_ptr(), out.data_ptr(), b, c, r, n, c * n, r * n,
            masks.ctypes.data, stream,
        )
        _build.check(err, "gf_bits (ALU arm) launch")
        BITS_ALU_LAUNCHES.inc()
        BITS_LAUNCHES.inc((r, c, n, b, key))
    return out


def apply_matrix_bits(
    a_bits: np.ndarray, inputs: torch.Tensor, args: BitArgs | None = None
) -> torch.Tensor:
    """[C, N] uint8 -> [R, N] uint8 (apply_matrix_bits_batch, B = 1)."""
    if inputs.dim() != 2:
        raise ValueError(f"apply_matrix_bits takes [C, N], got {tuple(inputs.shape)}")
    return apply_matrix_bits_batch(a_bits, inputs[None], args)[0]


def apply_matrix_bits_u32_batch(
    a_bits: np.ndarray, inputs_u32: torch.Tensor, args: BitArgs | None = None
) -> torch.Tensor:
    """[B, k, n32] int32 lanes -> [B, R, n32]: K5 on the lanes' bytes
    (a view, no copy), byte-identical to K2 on the same lanes."""
    if inputs_u32.dtype != torch.int32 or inputs_u32.dim() != 3:
        raise ValueError(
            f"apply_matrix_bits_u32_batch takes [B, k, n32] int32, got "
            f"{tuple(inputs_u32.shape)} {inputs_u32.dtype}"
        )
    b, k, n32 = inputs_u32.shape
    u8 = inputs_u32.contiguous().view(torch.uint8).reshape(b, k, n32 * 4)
    out = apply_matrix_bits_batch(a_bits, u8, args)
    return out.view(torch.int32).reshape(b, out.shape[1], n32)


def apply_matrix_bits_u32(
    a_bits: np.ndarray, inputs_u32: torch.Tensor, args: BitArgs | None = None
) -> torch.Tensor:
    """[k, n32] int32 lanes -> [R, n32] (apply_matrix_bits_u32_batch,
    B = 1)."""
    if inputs_u32.dim() != 2:
        raise ValueError(
            f"apply_matrix_bits_u32 takes [k, n32], got {tuple(inputs_u32.shape)}"
        )
    return apply_matrix_bits_u32_batch(a_bits, inputs_u32[None], args)[0]


_BITS_CACHE: dict[bytes, tuple[np.ndarray, BitArgs]] = {}


def _cached_bits(matrix: np.ndarray) -> tuple[np.ndarray, BitArgs]:
    """(bit-matrix, K5's matrix argument) of a GF matrix, memoized: a
    decode calls the backend with one of a few matrices many times."""
    key = matrix.tobytes() + bytes(matrix.shape)
    with _lib_lock:
        got = _BITS_CACHE.get(key)
    if got is None:
        a_bits = gf_matrix_to_bits(matrix)
        got = (a_bits, bit_args(a_bits))
        with _lib_lock:
            if len(_BITS_CACHE) > 512:
                _BITS_CACHE.clear()  # bound, rarely hit
            _BITS_CACHE[key] = got
    return got


# --- host interop backend ---------------------------------------------------


def _bucket_len(n: int) -> int:
    """Round a byte-stream length up to a power of two (min 1 KiB), as
    the reference does, so the serving path meets few distinct shapes."""
    return max(1024, 1 << (n - 1).bit_length())


def resolve_device(device) -> torch.device:
    """The device an entry point runs on: the card unless the caller
    asked for the CPU. Raises when the card is asked for and absent."""
    dev = torch.device(device if device is not None else "cuda")
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "the cuda EC backend needs a CUDA device; pass device='cpu' "
            "to run its plain versions on the host"
        )
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {dev}")
    return dev


def cuda_apply_matrix(
    matrix: np.ndarray, inputs: np.ndarray, device=None
) -> np.ndarray:
    """Backend for codec.ReedSolomon: numpy [C, N] uint8 in, [R, N]
    uint8 out. Zero-pads the stream to a size bucket (GF math is
    positionwise, so padding never changes the first N bytes), runs K5
    for a bucket under SWAR_MIN_BYTES and K1 from there up, on `device`
    (default: the card), and returns the first N bytes."""
    dev = resolve_device(device)
    matrix = np.asarray(matrix, dtype=np.uint8)
    n = inputs.shape[1]
    nb = _bucket_len(n)
    padded = np.zeros((inputs.shape[0], nb), dtype=np.uint8)
    padded[:, :n] = inputs
    if nb < SWAR_MIN_BYTES:
        a_bits, args = _cached_bits(matrix)
        out = apply_matrix_bits(a_bits, torch.from_numpy(padded).to(dev), args)
        return out.cpu().numpy()[:, :n]
    x = torch.from_numpy(padded.view(np.int32)).to(dev)
    out = gf_apply_u32(matrix, x)
    return out.cpu().numpy().view(np.uint8)[:, :n]


register_backend("cuda", cuda_apply_matrix)


# --- kernel state for one RS(k, p) code ------------------------------------


@dataclass
class CodecState:
    """What the kernels need for one code matrix: the [n, k] matrix,
    the term words (gf_terms) of the parity rows, and a decode-row cache
    keyed by (survivors, targets). K4 keeps its own tables, per device
    (crc_kernel)."""

    matrix: np.ndarray
    parity_terms: tuple[np.ndarray, np.ndarray]
    decode_cache: dict = field(default_factory=dict)


def codec_state_from_numpy(matrix: np.ndarray) -> CodecState:
    """Kernel state from a numpy [n, k] coefficient matrix, as
    seaweedfs_tpu's TpuCodecKernels.matrix holds it."""
    matrix = np.ascontiguousarray(np.asarray(matrix, dtype=np.uint8))
    n, k = matrix.shape
    if n <= k or not np.array_equal(matrix[:k], np.eye(k, dtype=np.uint8)):
        raise ValueError("expected a systematic [n, k] code matrix")
    return CodecState(
        matrix=matrix,
        parity_terms=gf_terms(matrix[k:]),
    )


class CudaCodecKernels:
    """Device-resident kernels for one RS(k, p) code (the counterpart of
    TpuCodecKernels). Tiles are [k, n32] int32 lane tensors on
    `device`; results stay there."""

    def __init__(
        self,
        data_shards: int = 10,
        parity_shards: int = 4,
        device=None,
        matrix: np.ndarray | None = None,
    ):
        self.data_shards = data_shards
        self.parity_shards = parity_shards
        self.total_shards = data_shards + parity_shards
        self.device = resolve_device(device)
        if matrix is None:
            matrix = gf256.build_code_matrix(data_shards, self.total_shards)
        self.state = codec_state_from_numpy(matrix)
        self.matrix = self.state.matrix
        self._lock = threading.Lock()

    def encode_u32(self, data_u32: torch.Tensor) -> torch.Tensor:
        """[k, n32] lanes -> parity [p, n32] lanes."""
        return gf_apply_u32(
            self.matrix[self.data_shards :], data_u32, self.state.parity_terms
        )

    def encode_u32_crc(
        self, data_u32: torch.Tensor
    ) -> tuple[torch.Tensor, torch.Tensor]:
        """(parity [p, n32], crcs [k+p] int32): K1 then K4 over the data
        rows and the parity rows, on the same stream — the standard
        CRC-32C of every shard row, data rows included."""
        k, n32 = data_u32.shape
        tile = torch.empty(
            (self.total_shards, n32), dtype=torch.int32, device=data_u32.device
        )
        tile[:k].copy_(data_u32)
        return tile[k:], self.encode_tile_crc(tile)

    def encode_tile_crc(self, tile: torch.Tensor) -> torch.Tensor:
        """In place on a [k+p, n32] tile whose first k rows hold the
        data: K1 writes the parity into rows k.., then one K4 launch
        checksums all k+p rows. Returns the [k+p] int32 CRCs."""
        k = self.data_shards
        gf_apply_u32(
            self.matrix[k:], tile[:k], self.state.parity_terms, out=tile[k:]
        )
        return crc_kernel.crc32c_rows(tile)

    def decode_rows_for(
        self, survivors: tuple[int, ...], targets: tuple[int, ...]
    ) -> np.ndarray:
        """GF rows mapping the k survivor shards (ascending) to
        `targets`, cached with their term words."""
        return self._decode(survivors, targets)[0]

    def _decode(self, survivors, targets):
        key = (tuple(survivors), tuple(targets))
        with self._lock:
            got = self.state.decode_cache.get(key)
        if got is None:
            rows = gf256.decode_rows(self.matrix, key[0], key[1])
            got = (rows, gf_terms(rows))
            with self._lock:
                if len(self.state.decode_cache) > 512:
                    self.state.decode_cache.clear()  # bound, rarely hit
                self.state.decode_cache[key] = got
        return got

    def reconstruct_u32(
        self,
        survivors: tuple[int, ...],
        targets: tuple[int, ...],
        shard_data_u32: torch.Tensor,
    ) -> torch.Tensor:
        """Survivor tile [k, n32] (in `survivors` order) -> rebuilt
        [len(targets), n32] lanes."""
        rows, terms = self._decode(survivors, targets)
        return gf_apply_u32(rows, shard_data_u32, terms)

    def reconstruct_u32_crc(
        self,
        survivors: tuple[int, ...],
        targets: tuple[int, ...],
        shard_data_u32: torch.Tensor,
    ) -> tuple[torch.Tensor, torch.Tensor]:
        """(rebuilt [len(targets), n32], crcs [len(targets)] int32)."""
        rebuilt = self.reconstruct_u32(survivors, targets, shard_data_u32)
        return rebuilt, crc_kernel.crc32c_rows(rebuilt)

    # --- batches of volumes: [B, rows, n32] lanes (K2, K3, K4) ---

    def encode_batch_u32(self, data_u32: torch.Tensor) -> torch.Tensor:
        """[B, k, n32] lanes -> parity [B, p, n32] lanes, one K2 launch."""
        return gf_apply_u32_batch(
            self.matrix[self.data_shards :], data_u32, self.state.parity_terms
        )

    def batch_tile_parts(self, tile: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
        """A batch tile is a contiguous [B*(k+p), n32] lane tensor: the
        data [B, k, n32] followed by the parity [B, p, n32], both
        contiguous views (so the H2D of the data and the D2H of the
        parity are plain copies). Returns (data, parity)."""
        k, n = self.data_shards, self.total_shards
        rows, n32 = tile.shape
        if rows % n or not tile.is_contiguous():
            raise ValueError(f"a batch tile is a contiguous [B*{n}, n32] tensor")
        b = rows // n
        return tile[: b * k].view(b, k, n32), tile[b * k :].view(b, n - k, n32)

    def encode_batch_tile_crc(
        self, tile: torch.Tensor, raw: bool = False
    ) -> torch.Tensor:
        """In place on a batch tile (batch_tile_parts) whose data part
        holds the volumes: one K2 launch writes the parity part, then one
        K4 launch checksums all B*(k+p) rows. Returns the [B, k+p] int32
        CRCs in shard order (raw=True: the raw CRCs, zero init and no
        final xor, which compose across stream segments)."""
        data, parity = self.batch_tile_parts(tile)
        gf_apply_u32_batch(
            self.matrix[self.data_shards :], data, self.state.parity_terms, out=parity
        )
        crcs = crc_kernel.crc_lin_rows(tile) if raw else crc_kernel.crc32c_rows(tile)
        b, k = data.shape[:2]
        return torch.cat((crcs[: b * k].view(b, k), crcs[b * k :].view(b, -1)), dim=1)

    def reconstruct_batch_u32(
        self,
        survivors: tuple[int, ...],
        targets: tuple[int, ...],
        shard_data_u32: torch.Tensor,
    ) -> torch.Tensor:
        """Survivor batch [B, k, n32] (in `survivors` order) -> rebuilt
        [B, len(targets), n32] lanes, one K2 launch."""
        rows, terms = self._decode(survivors, targets)
        return gf_apply_u32_batch(rows, shard_data_u32, terms)

    def verify_batch_u32(
        self, data_u32: torch.Tensor, parity_u32: torch.Tensor
    ) -> torch.Tensor:
        """[B] int32 mismatched-lane counts of the given parity against
        the data's, one K3 launch."""
        return gf_verify_u32_batch(
            self.matrix[self.data_shards :], data_u32, parity_u32,
            self.state.parity_terms,
        )
