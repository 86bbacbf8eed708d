"""Build-at-first-use for the port's native code, and launch counters.

Every source under ``csrc/`` is compiled into ``_build/`` (listed in
.gitignore) the first time something needs it:

  *.cu  ``nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared``
        into a shared library with a plain C interface (no PyTorch
        headers: that build takes minutes, this one seconds);
  *.c   the host shims, with the system C compiler.

Libraries are loaded with ctypes. An artifact's name carries a digest
of its source (with the shared ``*.cuh`` headers) and flags, so an
edited source is never served stale code, and it is published by
rename, so concurrent test workers that build the same source race
harmlessly. A failed build raises: there is no fallback to a plain
version behind the caller's back.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading

_HERE = os.path.dirname(os.path.abspath(__file__))
CSRC = os.path.join(_HERE, "csrc")
BUILD_DIR = os.path.join(_HERE, "_build")

NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
    "-Xptxas", "-v",
)
CC_FLAGS = ("-O2", "-shared", "-fPIC", "-Wall", "-Wextra", "-Werror")

CUDA_SOURCES = ("gf_apply.cu", "gf_verify.cu", "crc32c_rows.cu", "gf_bits.cu")

_lock = threading.Lock()
_libs: dict[str, ctypes.CDLL] = {}
# compiler output per source (ptxas register/shared-memory report)
build_logs: dict[str, str] = {}


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME") or "/usr/local/cuda"
    path = os.path.join(home, "bin", "nvcc")
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")
    return path


def _cc() -> str:
    for name in ("cc", "gcc", "clang"):
        found = shutil.which(name)
        if found:
            return found
    raise RuntimeError("no C compiler found: the host CRC shim cannot be built")


def _command(src: str) -> tuple[list[str], str]:
    path = os.path.join(CSRC, src)
    with open(path, "rb") as f:
        body = f.read()
    if src.endswith(".cu"):
        tool, flags = _nvcc(), NVCC_FLAGS
        # the shared headers are part of every CUDA source's digest
        for name in sorted(os.listdir(CSRC)):
            if name.endswith(".cuh"):
                with open(os.path.join(CSRC, name), "rb") as f:
                    body += f.read()
    else:
        tool, flags = _cc(), CC_FLAGS
    digest = hashlib.sha256(body + " ".join(flags).encode()).hexdigest()[:16]
    stem = os.path.splitext(src)[0]
    out = os.path.join(BUILD_DIR, f"lib{stem}.{digest}.so")
    tmp = f"{out}.tmp{os.getpid()}.{threading.get_ident()}"
    return [tool, *flags, "-o", tmp, path], out


def build(sources=CUDA_SOURCES) -> dict[str, str]:
    """Compile every stale source at once (one compiler process per
    source, all started together) and return {source: library path}.
    Raises RuntimeError carrying the compiler's output on failure."""
    os.makedirs(BUILD_DIR, exist_ok=True)
    paths, procs = {}, {}
    for src in sources:
        cmd, out = _command(src)
        paths[src] = out
        if not os.path.exists(out):
            procs[src] = (
                subprocess.Popen(
                    cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT
                ),
                cmd[-2],
                out,
            )
    failed = []
    for src, (proc, tmp, out) in procs.items():
        log = proc.communicate()[0].decode(errors="replace")
        build_logs[src] = log
        if proc.returncode != 0:
            failed.append(f"{src}:\n{log}")
            continue
        os.replace(tmp, out)
    if failed:
        raise RuntimeError("kernel build failed\n" + "\n".join(failed))
    return paths


def load(src: str) -> ctypes.CDLL:
    """The loaded library built from csrc/`src` (built on first use)."""
    with _lock:
        lib = _libs.get(src)
        if lib is None:
            lib = _libs[src] = ctypes.CDLL(build((src,))[src])
        return lib


def check(err: int, what: str) -> None:
    """Raise on a nonzero cudaError_t returned by a C entry point."""
    if err:
        raise RuntimeError(f"{what}: CUDA error {err}")


COUNTERS: dict[str, "LaunchCounter"] = {}  # every wrapper's counter, by name


class LaunchCounter:
    """Kernel launches through one wrapper: bumped where the wrapper
    launches its kernel and nowhere else (thread-safe). A launch may
    name its signature (what its time depends on: its shape, and for
    the GF kernels the coefficient matrix), tallied beside the count
    (`by_signature`); a thread reads its own launches with `mine`.
    Each counter is listed in COUNTERS, which a server's /metrics
    reports (stats/metrics.KERNEL_LAUNCHES)."""

    def __init__(self, name: str):
        COUNTERS[name] = self
        self.name = name
        self._n = 0
        self._by: dict = {}
        self._lock = threading.Lock()
        self._local = threading.local()

    def inc(self, signature=None) -> None:
        with self._lock:
            self._n += 1
            if signature is not None:
                self._by[signature] = self._by.get(signature, 0) + 1
        mine = self._local.__dict__
        mine["n"] = mine.get("n", 0) + 1
        if signature is not None:
            by = mine.setdefault("by", {})
            by[signature] = by.get(signature, 0) + 1

    @property
    def value(self) -> int:
        return self._n

    def by_signature(self) -> dict:
        """{signature: launches} since the last reset."""
        with self._lock:
            return dict(self._by)

    def mine(self) -> tuple[int, dict]:
        """The calling thread's launches since it started, and their
        tally by signature (reset leaves them; read them as deltas)."""
        mine = self._local.__dict__
        return mine.get("n", 0), dict(mine.get("by", {}))

    def reset(self) -> None:
        with self._lock:
            self._n = 0
            self._by = {}
