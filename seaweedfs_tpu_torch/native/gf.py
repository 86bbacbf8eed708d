"""ctypes wrapper for the SIMD GF(2^8) matrix-apply shim (csrc/gf256.c):
the "native" host codec, the port's counterpart of
seaweedfs_tpu/native/gf.py.

The shim picks one of four paths when it is loaded (GFNI+AVX512, AVX2,
SSSE3, portable; `caps()` says which). It is built with the system C
compiler the first time it is called, never at import; a failed build
or load raises RuntimeError carrying the compiler's message. ctypes
releases the GIL for the call, so the pipelined drivers' writer pools
run it in parallel.
"""

from __future__ import annotations

import ctypes
import threading

import numpy as np

from seaweedfs_tpu_torch import _build

_u8p = ctypes.POINTER(ctypes.c_uint8)
CAPS_NAMES = {3: "gfni+avx512", 2: "avx2", 1: "ssse3", 0: "portable"}

_lib = None
_lock = threading.Lock()


def load() -> ctypes.CDLL:
    """The built and loaded shim (built on first use; raises
    RuntimeError when it cannot be built or loaded)."""
    global _lib
    if _lib is None:
        with _lock:
            if _lib is None:
                try:
                    lib = _build.load("gf256.c")
                    lib.weed_gf_apply.restype = None
                    lib.weed_gf_apply.argtypes = (
                        _u8p,  # matrix [r*k]
                        ctypes.c_int32,  # r
                        ctypes.c_int32,  # k
                        ctypes.POINTER(_u8p),  # inputs  [k] row pointers
                        ctypes.POINTER(_u8p),  # outputs [r] row pointers
                        ctypes.c_size_t,  # n
                    )
                    lib.weed_gf_caps.restype = ctypes.c_int32
                    lib.weed_gf_caps.argtypes = ()
                except (OSError, AttributeError) as e:
                    raise RuntimeError(f"the native gf256 shim cannot be loaded: {e}") from e
                _lib = lib
    return _lib


def caps() -> str:
    """The SIMD path the shim chose on this host."""
    return CAPS_NAMES[int(load().weed_gf_caps())]


def apply_matrix(matrix: np.ndarray, inputs: np.ndarray) -> np.ndarray:
    """out[r] = XOR_c gfmul(matrix[r,c], inputs[c]) over the 0x11D field.

    matrix [R, C] u8, inputs [C, N] u8 → [R, N] u8: the contract of
    codec.cpu_apply_matrix (rows of the C-contiguous arrays are passed
    as raw pointers; no copies beyond contiguity normalization)."""
    lib = load()
    matrix = np.ascontiguousarray(matrix, dtype=np.uint8)
    inputs = np.ascontiguousarray(inputs, dtype=np.uint8)
    r, k = matrix.shape
    if inputs.shape[0] != k:
        raise ValueError(f"matrix has {k} columns but inputs has {inputs.shape[0]} rows")
    n = inputs.shape[1]
    out = np.empty((r, n), dtype=np.uint8)
    in_ptrs = (_u8p * k)(*(inputs[i].ctypes.data_as(_u8p) for i in range(k)))
    out_ptrs = (_u8p * r)(*(out[i].ctypes.data_as(_u8p) for i in range(r)))
    lib.weed_gf_apply(matrix.ctypes.data_as(_u8p), r, k, in_ptrs, out_ptrs, n)
    return out
