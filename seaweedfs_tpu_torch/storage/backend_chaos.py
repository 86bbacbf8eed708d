"""weedchaos shim for the backend SPI: wrap any BackendStorage in a
fault injector (the DiskChaos analogue for the remote tier). A
ChaosBackendStorage registered in place of the real one makes every
tier upload/download/ranged-read go through seeded fault draws —
`eio` raises, `slow` sleeps — so tests can prove degraded reads and
tier retries behave under a misbehaving object store without touching
the backend implementations themselves."""

from __future__ import annotations

import random
import threading
import time

from seaweedfs_tpu_torch.storage import backend as b

_OPS = ("read", "upload", "download", "delete")


class BackendFault:
    """One fault rule: mode ∈ eio|slow, ops ⊆ read,upload,download,delete,
    probability in [0,1], delay for slow."""

    def __init__(
        self,
        mode: str,
        ops: tuple[str, ...] = ("read",),
        probability: float = 1.0,
        delay_s: float = 0.05,
    ):
        if mode not in ("eio", "slow"):
            raise ValueError(f"backend fault mode {mode!r} not eio|slow")
        for op in ops:
            if op not in _OPS:
                raise ValueError(f"backend fault op {op!r} not in {_OPS}")
        self.mode = mode
        self.ops = tuple(ops)
        self.probability = probability
        self.delay_s = delay_s


class _ChaosFile(b.BackendStorageFile):
    def __init__(self, chaos: "ChaosBackendStorage", inner: b.BackendStorageFile):
        self.chaos = chaos
        self.inner = inner

    def read_at(self, length: int, offset: int) -> bytes:
        self.chaos._maybe_fault("read")
        return self.inner.read_at(length, offset)

    def write_at(self, data: bytes, offset: int) -> int:
        return self.inner.write_at(data, offset)

    def truncate(self, size: int) -> None:
        self.inner.truncate(size)

    def close(self) -> None:
        self.inner.close()

    def get_stat(self) -> tuple[int, float]:
        return self.inner.get_stat()

    def name(self) -> str:
        return self.inner.name()


class ChaosBackendStorage(b.BackendStorage):
    """Registers under the SAME name as the wrapped backend, so code
    resolving `dir.default` through get_backend() transparently hits
    the shim. injected/raised counters are the test observables."""

    def __init__(
        self,
        inner: b.BackendStorage,
        faults: list[BackendFault] | None = None,
        seed: int = 0,
    ):
        self.inner = inner
        self.storage_type = inner.storage_type
        self.id = inner.id
        self.faults: list[BackendFault] = list(faults or [])
        self._rng = random.Random(seed)
        self._lock = threading.Lock()
        self.injected = 0  # total fault draws that hit (slow + eio)
        self.raised = 0  # eio subset

    def heal(self) -> None:
        with self._lock:
            self.faults = []

    def _maybe_fault(self, op: str) -> None:
        with self._lock:
            faults = list(self.faults)
            draws = [self._rng.random() for _ in faults]
        for fault, draw in zip(faults, draws):
            if op not in fault.ops or draw >= fault.probability:
                continue
            with self._lock:
                self.injected += 1
            if fault.mode == "slow":
                time.sleep(fault.delay_s)
            else:
                with self._lock:
                    self.raised += 1
                raise IOError(
                    f"chaos backend: injected EIO on {op} ({self.name})"
                )

    def to_properties(self) -> dict:
        return self.inner.to_properties()

    def new_storage_file(self, key: str, file_size: int) -> _ChaosFile:
        return _ChaosFile(self, self.inner.new_storage_file(key, file_size))

    def copy_file(self, local_path: str, attributes: dict, progress=None):
        self._maybe_fault("upload")
        return self.inner.copy_file(local_path, attributes, progress)

    def download_file(self, local_path: str, key: str, progress=None) -> int:
        self._maybe_fault("download")
        return self.inner.download_file(local_path, key, progress)

    def delete_file(self, key: str) -> None:
        self._maybe_fault("delete")
        self.inner.delete_file(key)
