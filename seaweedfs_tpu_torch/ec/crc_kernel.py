"""K4: CRC-32C of u32-lane shard rows on the device.

The counterpart of seaweedfs_tpu/ec/crc_kernel.py (crc_lin_rows /
crc32c_rows): the streaming stages checksum every shard row while the
tile is on the card, so the host never re-reads parity bytes to stamp
CRCs. On a CUDA tensor the wrapper launches csrc/crc32c_rows.cu (see
its header for the design and bound); on a CPU tensor it runs the
plain version below, which the tests hold against the reference.

Both rest on GF(2)-linearity: with the init/final-xor constants
stripped, a CRC register is a linear function of the message bits, so
  * the raw CRC of one u32 lane is a 32-column operator (`_lane_cols`);
  * adjacent pieces combine as crc(A||B) = Z_|B|(crc(A)) ^ crc(B),
    with Z_k the k-zero-byte transit (util/crc._zero_shift_cols);
  * leading zero bytes leave a raw CRC unchanged, so a row of any
    length can be front-padded to a convenient one;
  * the constants re-enter as one per-length XOR (`_final_const`).
"""

from __future__ import annotations

import ctypes
import functools
import threading

import numpy as np
import torch

from seaweedfs_tpu_torch import _build
from seaweedfs_tpu_torch.util import crc as _crc

LAUNCHES = _build.LaunchCounter("crc32c_rows")

# geometry of csrc/crc32c_rows.cu: blocks of 256 threads, 6 resident a
# SM; a thread takes a span of one of SPANS bytes, a chunk 256 spans
_THREADS = 256
_BLOCKS_PER_SM = 6
SPANS = (16, 32, 64)
# a block's fixed cost (table copy, combine, ticket) in byte steps
_BLOCK_STEPS = 64
H100_SMS = 132


def crc_supported(nbytes: int) -> bool:
    """True when the streaming stages take the fused device CRC for a
    row of `nbytes` stream bytes: whole u32 lanes, power-of-two lane
    count (the reference's contract; other tiles are checksummed on
    the host)."""
    if nbytes <= 0 or nbytes % 4:
        return False
    n32 = nbytes // 4
    return n32 & (n32 - 1) == 0


def _raw_transit(data: bytes, reg: int) -> int:
    """CRC register after `data` starting from `reg` (constants off)."""
    return _crc.crc32c(data, reg ^ 0xFFFFFFFF) ^ 0xFFFFFFFF


@functools.lru_cache(maxsize=1)
def _lane_cols() -> tuple[int, ...]:
    """Columns of the lane operator: raw CRC of the 4-byte
    little-endian message holding lane bit b."""
    return tuple(
        _raw_transit((1 << b).to_bytes(4, "little"), 0) for b in range(32)
    )


@functools.lru_cache(maxsize=128)
def _final_const(nbytes: int) -> int:
    """crc32c(M) = crc_raw0(M) ^ _final_const(len(M))."""
    return _crc._gf2_apply(
        _crc._zero_shift_cols(nbytes), 0xFFFFFFFF
    ) ^ 0xFFFFFFFF if nbytes else 0


def geometry(rows: int, n32: int, sms: int = H100_SMS) -> tuple[int, int, int]:
    """(span bytes a thread, chunks a row, fold run) of csrc/crc32c_rows.cu
    for a [rows, n32] tile on a card of `sms` SMs: one block for each of
    the rows x chunks, in waves of 6 x sms resident blocks.

    A span counts only if it gives fewer blocks than the next smaller one
    (a longer span over the same chunks would only look up more padding).
    Of the spans whose grid reaches every SM (all of them when none
    does), the one with the least waves x (span + 64): a wave costs its
    span's byte steps plus a block's fixed cost (table copy, combine,
    ticket), which is about 64 byte steps; a tie goes to the longer span.
    The fold run is the least power of two with 256 runs covering the
    chunks."""
    slots = sms * _BLOCKS_PER_SM

    def blocks(span: int) -> int:
        return rows * -(-4 * n32 // (_THREADS * span))

    spans = [s for i, s in enumerate(SPANS) if i == 0 or blocks(s) < blocks(SPANS[i - 1])]
    reach = [s for s in spans if blocks(s) >= sms] or spans[:1]
    span = min(reach, key=lambda s: (-(-blocks(s) // slots) * (s + _BLOCK_STEPS), -s))
    nchunks = blocks(span) // rows
    run = 1
    while _THREADS * run < nchunks:
        run *= 2
    return span, nchunks, run


def byte_table() -> tuple[int, ...]:
    """Sarwate's CRC-32C byte table (util/crc's): entry b is the raw CRC
    of byte b."""
    return tuple(_crc._TABLE)


def _family(shifts) -> list[int]:
    """Operators Z_n for n in `shifts`, column b of operator j at
    b * len(shifts) + j."""
    cols = [_crc._zero_shift_cols(n) for n in shifts]
    return [c[b] for b in range(32) for c in cols]


@functools.lru_cache(maxsize=32)
def kernel_zcols(span: int, run: int) -> np.ndarray:
    """The Z operators csrc/crc32c_rows.cu combines with, for a span of
    `span` bytes a thread and a row fold of `run` chunks a thread, as
    uint32 columns in the layout its header gives: per-lane and per-warp
    shifts within a chunk, one chunk's shift, then per-lane and per-warp
    shifts of the row fold's runs."""
    warps = _THREADS // 32
    chunk = _THREADS * span
    run_bytes = chunk * run
    return np.array(
        _family([span * (31 - l) for l in range(32)])
        + _family([32 * span * (warps - 1 - w) for w in range(warps)])
        + _crc._zero_shift_cols(chunk)
        + _family([run_bytes * (31 - l) for l in range(32)])
        + _family([run_bytes * 32 * (warps - 1 - w) for w in range(warps)]),
        dtype=np.uint32,
    )


# --- plain version ----------------------------------------------------------


def _apply_cols(x: torch.Tensor, cols) -> torch.Tensor:
    """Apply a 32-column GF(2) operator to every element of an int64
    tensor holding u32 values: the bit-matmul mod 2, written as the
    XOR of the columns each set bit selects (integer matmul is not
    implemented for CUDA tensors, so this form runs on either)."""
    out = torch.zeros_like(x)
    for b, col in enumerate(cols):
        out ^= ((x >> b) & 1) * int(col)
    return out


def crc_lin_rows_plain(x_u32: torch.Tensor) -> torch.Tensor:
    """[..., n32] u32 lanes (int32 carrier) -> [...] int64 RAW CRC of
    each row: lane operator, then log2 halving rounds through Z shifts
    (rows front-padded with zero lanes to a power of two)."""
    n32 = x_u32.shape[-1]
    x = x_u32.to(torch.int64) & 0xFFFFFFFF
    p2 = 1 << max(0, (n32 - 1).bit_length())
    if p2 != n32:
        x = torch.nn.functional.pad(x, (p2 - n32, 0))
    c = _apply_cols(x, _lane_cols())
    span = 4  # bytes covered by each element of c
    while c.shape[-1] > 1:
        c = _apply_cols(c[..., 0::2], _crc._zero_shift_cols(span)) ^ c[..., 1::2]
        span *= 2
    return c[..., 0]


def crc32c_rows_plain(x_u32: torch.Tensor) -> torch.Tensor:
    """Standard CRC-32C of each row, as int32 bit patterns."""
    lin = crc_lin_rows_plain(x_u32) ^ _final_const(x_u32.shape[-1] * 4)
    return _as_i32(lin)


def _as_i32(v: torch.Tensor) -> torch.Tensor:
    """int64 holding u32 values -> int32 with the same bit pattern."""
    return torch.where(v >= 1 << 31, v - (1 << 32), v).to(torch.int32)


# --- kernel wrapper ---------------------------------------------------------

_lib_lock = threading.Lock()
_lib = None
_TICKETS = 65535  # ticket counters a stream keeps: a grid's most rows
# per device: byte table; per (device, span, run): Z columns; per
# (device, stream): ticket counters, zero between launches (a launch
# inside a CUDA graph capture gets counters of its own instead)
_tables: dict[torch.device, torch.Tensor] = {}
_zcols_dev: dict[tuple[torch.device, int, int], torch.Tensor] = {}
_tickets: dict[tuple[torch.device, int], torch.Tensor] = {}


def _kernel():
    global _lib
    with _lib_lock:
        if _lib is None:
            lib = _build.load("crc32c_rows.cu")
            lib.crc32c_rows_u32.restype = ctypes.c_int
            lib.crc32c_rows_u32.argtypes = (
                ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                ctypes.c_void_p, ctypes.c_void_p, ctypes.c_longlong,
                ctypes.c_longlong, ctypes.c_int, ctypes.c_longlong,
                ctypes.c_uint, ctypes.c_void_p,
            )
            _lib = lib
        return _lib


def _u32_tensor(words, device: torch.device) -> torch.Tensor:
    return torch.from_numpy(np.asarray(words, dtype=np.uint32).view(np.int32)).to(device)


def _device_state(device: torch.device, rows: int, n32: int, stream: int):
    """(geometry, byte table, Z columns, ticket counters) for a launch:
    the tables per device and the Z columns per (device, span, run),
    each made once and kept, by a first call at the geometry outside any
    CUDA graph capture (they are copied from host memory). An
    uncaptured launch takes its stream's
    counters, made and zeroed at the stream's first uncaptured call: a
    stream runs its launches in order, and each launch leaves them
    zero. A launch inside a CUDA graph capture gets [rows] counters of
    its own, allocated in the capture, so from the graph's private pool
    with their zero-fill captured ahead of the kernel: a graph owns its
    counters, and neither replays of several graphs on several streams
    at once nor uncaptured launches on the capture's stream can share
    them. (One graph never runs beside itself: CUDA orders the launches
    of a graph.)"""
    sms = torch.cuda.get_device_properties(device).multi_processor_count
    span, nchunks, run = geometry(rows, n32, sms)
    capturing = torch.cuda.is_current_stream_capturing()
    with _lib_lock:
        if capturing and (device not in _tables or (device, span, run) not in _zcols_dev):
            # they are copied from host memory, which a capture forbids
            raise RuntimeError(
                "crc32c_rows: the first call at a tile geometry copies its tables "
                "to the device and cannot be captured; call it once at this shape "
                "outside the capture first")
        table = _tables.get(device)
        if table is None:  # each entry four times: one 16-byte load a slot
            table = _tables[device] = _u32_tensor(np.repeat(byte_table(), 4), device)
        zc = _zcols_dev.get((device, span, run))
        if zc is None:
            zc = _zcols_dev[(device, span, run)] = _u32_tensor(kernel_zcols(span, run), device)
        if capturing:
            tickets = torch.zeros(rows, dtype=torch.int32, device=device)
        else:
            tickets = _tickets.get((device, stream))
            if tickets is None:
                tickets = _tickets[(device, stream)] = torch.zeros(
                    _TICKETS, dtype=torch.int32, device=device)
    return (span, nchunks, run), table, zc, tickets


def _launch(x_u32: torch.Tensor, final_const: int) -> torch.Tensor:
    if x_u32.dtype != torch.int32:
        raise TypeError(f"crc32c_rows takes int32 lanes, got {x_u32.dtype}")
    if x_u32.dim() != 2 or not x_u32.is_contiguous() or x_u32.shape[1] < 1:
        raise ValueError("crc32c_rows takes a contiguous [rows, n32] tile")
    rows, n32 = x_u32.shape
    if rows > _TICKETS:
        raise ValueError(f"crc32c_rows takes at most {_TICKETS} rows, got {rows}")
    lib = _kernel()
    dev = x_u32.device
    stream = torch.cuda.current_stream(dev).cuda_stream
    (span, nchunks, run), table, zc, tickets = _device_state(dev, rows, n32, stream)
    out = torch.empty(rows, dtype=torch.int32, device=dev)
    partial = torch.empty(rows * nchunks, dtype=torch.int32, device=dev)
    err = lib.crc32c_rows_u32(
        x_u32.data_ptr(), out.data_ptr(), partial.data_ptr(), tickets.data_ptr(),
        table.data_ptr(), zc.data_ptr(), rows, n32, span // 4, run,
        final_const & 0xFFFFFFFF, stream,
    )
    _build.check(err, "crc32c_rows launch")
    LAUNCHES.inc((rows, n32))
    return out


def crc32c_rows(x_u32: torch.Tensor) -> torch.Tensor:
    """[rows, n32] int32 lanes -> [rows] int32: the standard CRC-32C of
    each row's bytes, bit-identical to util/crc.crc32c. Launches K4 on
    a CUDA tensor (on the current stream); runs the plain version on
    a CPU tensor."""
    if x_u32.is_cuda:
        return _launch(x_u32, _final_const(x_u32.shape[-1] * 4))
    if x_u32.device.type != "cpu":
        raise ValueError(f"crc32c_rows: unsupported device {x_u32.device}")
    return crc32c_rows_plain(x_u32)


def crc_lin_rows(x_u32: torch.Tensor) -> torch.Tensor:
    """[rows, n32] int32 lanes -> [rows] int32 RAW CRCs (zero init, no
    final xor): the form that composes with Z shifts alone."""
    if x_u32.is_cuda:
        return _launch(x_u32, 0)
    if x_u32.device.type != "cpu":
        raise ValueError(f"crc_lin_rows: unsupported device {x_u32.device}")
    return _as_i32(crc_lin_rows_plain(x_u32))


def finalize_rows(lin: torch.Tensor, nbytes: int) -> torch.Tensor:
    """Raw row CRCs (int32 bit patterns) -> standard crc32c values."""
    c = _final_const(nbytes)
    return lin ^ (c - (1 << 32) if c >= 1 << 31 else c)


def combine_segments(lins: list[torch.Tensor], seg_bytes: int) -> torch.Tensor:
    """Raw CRCs of consecutive stream segments of `seg_bytes` each (int32
    bit patterns, any equal shapes, on any devices) -> the standard
    CRC-32C of the whole stream, on the first segment's device:
    crc(A||B) = Z_|B|(crc(A)) ^ crc(B), then the whole length's final
    constant. Plain torch ops: the fold touches a few words per row."""
    dev = lins[0].device
    zcols = _crc._zero_shift_cols(seg_bytes)
    acc = lins[0].to(torch.int64) & 0xFFFFFFFF
    for lin in lins[1:]:
        acc = _apply_cols(acc, zcols) ^ (lin.to(dev).to(torch.int64) & 0xFFFFFFFF)
    return finalize_rows(_as_i32(acc), seg_bytes * len(lins))
