"""Reed-Solomon codec: the `reedsolomon.Encoder` capability surface.

Same API and semantics as seaweedfs_tpu/ec/codec.py (ec_encoder.go:173
`enc.Encode`, store_ec.go:364 `enc.ReconstructData`):

  encode(shards)            fill parity shards k..n-1 from data 0..k-1
  reconstruct(shards)       rebuild ALL missing shards (None entries)
  reconstruct_data(shards)  rebuild only missing DATA shards
  verify(shards)            recompute parity, compare

Shards are equal-length 1-D uint8 numpy arrays (missing = None). The
byte math runs through a backend:

  "cuda"  K1 on the card (codec_cuda.py); device="cpu" runs its plain
          torch version on the host instead — only when asked
  "cpu"     numpy LUT / compiled XOR schedule — the bit-exact host codec
  "native"  the SIMD C shim (csrc/gf256.c, ec/codec_native.py): the host
            codec the card is judged against, registered on first use

The default is "cuda" unless WEED_EC_CODEC names another; the default
never picks a host codec by itself. There is no silent fallback: the
cuda backend raises when no card is present, and native raises when
its shim cannot be built.
"""

from __future__ import annotations

import functools
import os
from typing import Callable, Optional, Sequence

import numpy as np

from seaweedfs_tpu_torch.ec import gf256

DATA_SHARDS = 10
PARITY_SHARDS = 4
TOTAL_SHARDS = DATA_SHARDS + PARITY_SHARDS

# backend name -> apply_matrix(matrix [R,C] u8, inputs [C,N] u8) -> [R,N] u8
_BACKENDS: dict[str, Callable[..., np.ndarray]] = {}
_KNOWN = ("cpu", "cuda", "native")
_LAZY_BACKENDS = ("native",)  # registered on first use


def register_backend(name: str, fn: Callable[..., np.ndarray]) -> None:
    _BACKENDS[name] = fn


def cpu_apply_matrix(matrix: np.ndarray, inputs: np.ndarray) -> np.ndarray:
    """out[r] = XOR_c MUL[m[r,c]]·inputs[c] — vectorized LUT gathers."""
    r, c = matrix.shape
    if inputs.shape[0] != c:
        raise ValueError(f"matrix takes {c} input rows, got {inputs.shape[0]}")
    out = np.zeros((r, inputs.shape[1]), dtype=np.uint8)
    for ci in range(c):
        col = inputs[ci]
        for ri in range(r):
            coef = matrix[ri, ci]
            if coef == 0:
                continue
            if coef == 1:
                out[ri] ^= col
            else:
                out[ri] ^= gf256.MUL_TABLE[coef][col]
    return out


register_backend("cpu", cpu_apply_matrix)


def default_backend() -> str:
    """WEED_EC_CODEC when set (cpu, cuda or native), else cuda. Unlike
    the reference, nothing is detected: a host codec is used only when
    it is named, so a missing card is never hidden."""
    env = os.environ.get("WEED_EC_CODEC", "").strip().lower()
    if env:
        if env not in _KNOWN:
            raise ValueError(
                f"WEED_EC_CODEC={env!r} is not a known EC backend "
                f"(expected one of: {', '.join(_KNOWN)})"
            )
        return env
    return "cuda"


def resolve_backend(backend: str | None, device=None) -> str:
    """The backend an entry point will run (`backend`, else the
    default), checked up front: the cuda backend raises here when its
    device (None: the card) is absent, so a store or EC volume never
    comes up on a host that would fail its first decode."""
    name = backend or default_backend()
    if name == "cuda":
        from seaweedfs_tpu_torch.ec import codec_cuda

        codec_cuda.resolve_device(device)
    return name


class ReedSolomon:
    """Systematic RS(k, p) codec over GF(2^8), reference-field-compatible.

    `device` applies to the cuda backend: None means the card."""

    def __init__(
        self,
        data_shards: int = DATA_SHARDS,
        parity_shards: int = PARITY_SHARDS,
        backend: str | None = None,
        device=None,
    ):
        backend = backend or default_backend()
        if data_shards <= 0 or parity_shards <= 0:
            raise ValueError("shard counts must be positive")
        if data_shards + parity_shards > 256:
            raise ValueError("too many shards for GF(2^8)")
        self.data_shards = data_shards
        self.parity_shards = parity_shards
        self.total_shards = data_shards + parity_shards
        self.matrix = gf256.build_code_matrix(data_shards, self.total_shards)
        self.parity_rows = self.matrix[data_shards:].copy()
        self._backend_name = backend
        self.device = None
        if backend == "cuda":
            from seaweedfs_tpu_torch.ec import codec_cuda

            self.device = codec_cuda.resolve_device(device)
            self._apply = functools.partial(
                codec_cuda.cuda_apply_matrix, device=self.device
            )
        elif backend in _LAZY_BACKENDS:
            from seaweedfs_tpu_torch.ec import codec_native  # noqa: F401 registers
            from seaweedfs_tpu_torch.native import gf

            gf.load()  # build now: a missing compiler fails here, not mid-encode
            self._apply = _BACKENDS[backend]
        elif backend in _BACKENDS:
            self._apply = _BACKENDS[backend]
        else:
            raise ValueError(
                f"unknown EC backend {backend!r}; known: {sorted(_KNOWN)}"
            )
        # the numpy backend replays a compiled, pair-CSE'd XOR program
        # (ec/schedule.py); WEED_EC_SCHEDULE=0 restores the naive chain
        from seaweedfs_tpu_torch.ec import schedule as _schedule

        self.scheduled = backend == "cpu" and _schedule.schedule_enabled()
        if self.scheduled:
            self._apply = _schedule.scheduled_apply_matrix
            _schedule.compile_schedule(self.parity_rows)
        self._decode_cache: dict[tuple[int, ...], np.ndarray] = {}
        self._decode_rows_cache: dict[tuple, np.ndarray] = {}

    # --- helpers ---
    def _check_shards(
        self, shards: Sequence[Optional[np.ndarray]], allow_missing: bool
    ) -> int:
        if len(shards) != self.total_shards:
            raise ValueError(
                f"expected {self.total_shards} shards, got {len(shards)}"
            )
        size = None
        present = 0
        for s in shards:
            if s is None:
                if not allow_missing:
                    raise ValueError("missing shard")
                continue
            present += 1
            if s.dtype != np.uint8 or s.ndim != 1:
                raise ValueError("shards must be 1-D uint8 arrays")
            if size is None:
                size = s.shape[0]
            elif s.shape[0] != size:
                raise ValueError("shards must all be the same length")
        if size is None or size == 0:
            raise ValueError("no shard data")
        return present

    # --- Encoder surface ---
    def encode(self, shards: list[Optional[np.ndarray]]) -> list[np.ndarray]:
        """Fill shards[k..n-1] with parity computed from shards[0..k-1]."""
        k = self.data_shards
        if len(shards) != self.total_shards:
            raise ValueError(f"expected {self.total_shards} shards")
        data = [s for s in shards[:k]]
        if any(s is None for s in data):
            raise ValueError("all data shards required for encode")
        parity = self._apply(self.parity_rows, np.stack(data))
        for i in range(self.parity_shards):
            shards[k + i] = parity[i]
        return shards  # type: ignore[return-value]

    def parity_with_crc(
        self, stacked: np.ndarray
    ) -> tuple[np.ndarray, list[int]]:
        """([p, N] parity, [k+p] CRC-32C per shard row) for one [k, N]
        data tile: the host side of the fused-CRC stage contract."""
        from seaweedfs_tpu_torch.util.crc import crc32c

        parity = self._apply(self.parity_rows, stacked)
        crcs = [crc32c(stacked[i]) for i in range(self.data_shards)]
        crcs += [crc32c(parity[i]) for i in range(self.parity_shards)]
        return parity, crcs

    def verify(self, shards: Sequence[np.ndarray]) -> bool:
        self._check_shards(shards, allow_missing=False)
        k = self.data_shards
        parity = self._apply(self.parity_rows, np.stack(shards[:k]))
        return all(
            np.array_equal(parity[i], shards[k + i])
            for i in range(self.parity_shards)
        )

    def _decode_matrix(self, survivors: tuple[int, ...]) -> np.ndarray:
        m = self._decode_cache.get(survivors)
        if m is None:
            sub = gf256.sub_matrix_for_survivors(self.matrix, list(survivors))
            m = gf256.mat_inv(sub)
            self._decode_cache[survivors] = m
        return m

    def decode_rows(
        self, survivors: tuple[int, ...], targets: tuple[int, ...]
    ) -> np.ndarray:
        """Cached [len(targets), k] matrix rebuilding `targets` (data or
        parity) from `survivors`."""
        key = (tuple(survivors), tuple(targets))
        rows = self._decode_rows_cache.get(key)
        if rows is None:
            rows = gf256.decode_rows(self.matrix, key[0], key[1])
            if len(self._decode_rows_cache) > 512:
                self._decode_rows_cache.clear()  # bound, rarely hit
            self._decode_rows_cache[key] = rows
        return rows

    def reconstruct(
        self, shards: list[Optional[np.ndarray]], data_only: bool = False
    ) -> list[np.ndarray]:
        """Rebuild missing (None) shards in place: needs ≥ k present
        shards; with data_only, missing parity shards stay None."""
        k = self.data_shards
        present = self._check_shards(shards, allow_missing=True)
        missing = [i for i, s in enumerate(shards) if s is None]
        if not missing:
            return shards  # type: ignore[return-value]
        if present < k:
            raise ValueError(
                f"too few shards to reconstruct: {present} of {k} required"
            )
        survivors = tuple(i for i, s in enumerate(shards) if s is not None)[:k]
        stacked = np.stack([shards[i] for i in survivors])  # [k, N]
        missing_data = [i for i in missing if i < k]
        if missing_data:
            decode = self._decode_matrix(survivors)
            rows = decode[np.array(missing_data, dtype=np.intp)]
            rebuilt = self._apply(rows, stacked)
            for j, i in enumerate(missing_data):
                shards[i] = rebuilt[j]
        if not data_only:
            missing_parity = [i for i in missing if i >= k]
            if missing_parity:
                data_stacked = np.stack(shards[:k])
                rows = self.matrix[np.array(missing_parity, dtype=np.intp)]
                rebuilt = self._apply(rows, data_stacked)
                for j, i in enumerate(missing_parity):
                    shards[i] = rebuilt[j]
        return shards  # type: ignore[return-value]

    def reconstruct_data(
        self, shards: list[Optional[np.ndarray]]
    ) -> list[Optional[np.ndarray]]:
        return self.reconstruct(shards, data_only=True)


def new_encoder(
    data_shards: int = DATA_SHARDS,
    parity_shards: int = PARITY_SHARDS,
    backend: str | None = None,
    device=None,
) -> ReedSolomon:
    """Factory mirroring reedsolomon.New(10, 4) (ec_encoder.go:193):
    the cuda backend on the card unless told otherwise."""
    return ReedSolomon(data_shards, parity_shards, backend, device)
