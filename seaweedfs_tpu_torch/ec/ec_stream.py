"""Pipelined host↔device streaming drivers for EC encode and rebuild
(the counterpart of seaweedfs_tpu/ec/ec_stream.py): one volume at a
time through the CUDA stage pairs (K1, K4), or a batch of volumes per
round through a parallel.MeshCodec (K2, K4; see the batch section).

Output bytes match the classic loops in ec_files.py exactly, while
the stages overlap:

  disk reads (tiles t+1..)  ‖  H2D + K1 + K4 (tile t)  ‖  D2H + shard
  writes (tiles t-1..)

  * shard files are raw fds, preallocated to their final size and
    written with positioned os.pwritev at each tile's precomputed
    offset, so tile completion order never matters and close is free;
  * a READER POOL fills a bounded queue from a staging ring of host
    buffers (pinned memory when the stage pair runs on the card, so
    the H2D copy is asynchronous);
  * the dispatcher hands each tile to the stage pair's parity_fn, which
    enqueues H2D, the kernels and the D2H on a CUDA stream, records an
    event and returns;
  * a WRITER POOL waits on each tile's event (fetch_fn) and lands all
    rows with pwritev.

Only parity crosses device→host on encode; the ten data-shard files
are written straight from the host tile.

Role match: reference weed/storage/erasure_coding/ec_encoder.go:188-225
(encodeDatFile) and :227-281 (rebuildEcFiles).
"""

from __future__ import annotations

import contextlib
import errno
import os
import queue
import sys
import threading
import time
from concurrent.futures import ThreadPoolExecutor
from typing import Callable

import numpy as np
import torch

from seaweedfs_tpu_torch import trace
from seaweedfs_tpu_torch.ec import locate
from seaweedfs_tpu_torch.stats.metrics import (
    EC_REPAIR_BYTES_READ,
    EC_REPAIR_BYTES_WRITTEN,
)

DATA_SHARDS = locate.DATA_SHARDS
PARITY_SHARDS = locate.PARITY_SHARDS
TOTAL_SHARDS = locate.TOTAL_SHARDS
LARGE_BLOCK_SIZE = locate.LARGE_BLOCK_SIZE
SMALL_BLOCK_SIZE = locate.SMALL_BLOCK_SIZE

# Per-shard bytes per pipelined tile (the reference's default; small-
# tier rows fold into super-tiles of up to this many bytes per shard).
DEFAULT_TILE_BYTES = 1024 * 1024
# Dispatched-but-unfetched tiles queued toward the writer pool.
_INFLIGHT = 3


def pipeline_enabled() -> bool:
    """Kill switch: WEED_EC_PIPELINE=0 routes every encode/rebuild back
    through the serial classic drivers in ec_files.py (byte-identical)."""
    return os.environ.get("WEED_EC_PIPELINE", "1") != "0"


def pipeline_depth() -> int:
    """Dispatched-but-unfetched window: WEED_EC_PIPELINE_DEPTH, minimum
    2 (one tile on the device while the next stages), default 3."""
    try:
        d = int(os.environ.get("WEED_EC_PIPELINE_DEPTH", "0"))
    except ValueError:
        d = 0
    return max(2, d) if d > 0 else _INFLIGHT


def pipeline_batch_limit() -> int:
    """Max volumes per dispatch round on the batched drivers
    (WEED_EC_PIPELINE_BATCH, 0 = the whole batch in one round). Caps
    staging-ring memory: one ring slot is batch x 10 x tile bytes."""
    try:
        return max(0, int(os.environ.get("WEED_EC_PIPELINE_BATCH", "0")))
    except ValueError:
        return 0


class _StagingRing:
    """N host staging buffers cycled reader → dispatcher → writer →
    free, so pipeline memory is bounded and the allocator stays out of
    the hot loop. pinned=True allocates page-locked memory (the torch
    tensors are kept alive here; the pool threads see numpy views of
    them). A slot is allocated at its first acquire, so a run that
    needs fewer slots than the ring holds (a batch chunk of one round)
    never pays for the rest — the counterpart of the reference's
    np.empty, which the OS maps in only when touched."""

    def __init__(self, slots: int, slot_bytes: int, pinned: bool = False):
        self.slots = max(2, slots)
        self.slot_bytes = slot_bytes
        self.pinned = pinned
        self._tensors: list = [None] * self.slots
        self._bufs: list = [None] * self.slots
        self._free: queue.Queue = queue.Queue()
        for i in range(self.slots):
            self._free.put(i)

    def acquire(self, stop: threading.Event):
        """(slot id, flat uint8 buffer) or None when the pipeline
        aborted while waiting for a free slot."""
        i = _q_get(self._free, stop)
        if i is _STOPPED:
            return None
        if self._bufs[i] is None:  # only the holder of slot i gets here
            t = torch.empty(self.slot_bytes, dtype=torch.uint8, pin_memory=self.pinned)
            self._tensors[i] = t
            self._bufs[i] = t.numpy()
        return i, self._bufs[i]

    def release(self, slot_id: int) -> None:
        self._free.put(slot_id)

    def stats(self) -> dict:
        """ring_slots, ring_bytes (allocated so far) and ring_pinned."""
        used = sum(b is not None for b in self._bufs)
        return {
            "ring_slots": self.slots,
            "ring_bytes": used * self.slot_bytes,
            "ring_pinned": self.pinned,
        }


# Pool widths: the threads wait in GIL-released syscalls or device
# event waits, so a few keep the disks busy even on small hosts.
DEFAULT_WRITER_THREADS = min(8, max(3, (os.cpu_count() or 2) + 1))
DEFAULT_READER_THREADS = min(6, max(3, (os.cpu_count() or 2) // 2))

_EOF = object()  # end-of-stream marker flowing through the queues
_STOPPED = object()  # returned by _q_get when the pipeline aborted
_Q_TICK = 0.2  # seconds between stop-flag checks while blocked


def _q_put(q: queue.Queue, item, stop: threading.Event) -> bool:
    """put() that gives up when the pipeline aborts."""
    while not stop.is_set():
        try:
            q.put(item, timeout=_Q_TICK)
            return True
        except queue.Full:
            continue
    return False


def _q_get(q: queue.Queue, stop: threading.Event):
    while not stop.is_set():
        try:
            return q.get(timeout=_Q_TICK)
        except queue.Empty:
            continue
    return _STOPPED


class _Pipeline:
    """Reader/writer pool threads around the caller's dispatch loop,
    with first-error propagation and deadlock-free shutdown."""

    def __init__(self):
        self.stop = threading.Event()
        self.errors: list[BaseException] = []
        self._threads: list[threading.Thread] = []

    def spawn(self, fn) -> None:
        def run():
            try:
                fn()
            except BaseException as e:  # noqa: BLE001 — re-raised on join
                self.errors.append(e)
                self.stop.set()

        t = threading.Thread(target=run, daemon=True)
        t.start()
        self._threads.append(t)

    def finish(self, caller_error: bool = False) -> None:
        """Join the stage threads; re-raise the first stage error."""
        if caller_error:
            self.stop.set()
        for t in self._threads:
            t.join()
        if not caller_error and self.errors:
            raise self.errors[0]


# --- raw-fd IO primitives ---------------------------------------------------


def _preallocate(fd: int, size: int) -> None:
    """Reserve the file's final extent up front (ENOSPC fails before
    the pipeline starts); ftruncate where fallocate is unsupported."""
    if size <= 0:
        return
    try:
        os.posix_fallocate(fd, 0, size)
        return
    except OSError as e:
        if e.errno == errno.ENOSPC:
            raise
    os.ftruncate(fd, size)


def _pwrite_full(fd: int, buf, offset: int) -> None:
    _pwritev_full(fd, [buf], offset)


def _pwritev_full(fd: int, bufs, offset: int) -> None:
    """Positioned gathered write of every buffer, restarting across
    short writes (a silent short write would corrupt the shard)."""
    mvs = [memoryview(b).cast("B") for b in bufs]
    written = 0
    while mvs:
        w = os.pwritev(fd, mvs, offset + written)
        if w <= 0:
            raise OSError(errno.EIO, f"short pwritev at {offset + written}")
        written += w
        while mvs and w >= len(mvs[0]):
            w -= len(mvs[0])
            mvs.pop(0)
        if mvs and w:
            mvs[0] = mvs[0][w:]


def _pread_into(fd: int, view, offset: int) -> int:
    """Positioned read filling `view`; stops early only at EOF."""
    mv = memoryview(view).cast("B")
    got = 0
    n = len(mv)
    while got < n:
        r = os.preadv(fd, [mv[got:]], offset + got)
        if r == 0:
            break
        got += r
    return got


def _close_and_sync(fds, durable: bool, ok: bool, pipe: _Pipeline) -> OSError | None:
    """Close every fd (fsyncing first on a durable success); return the
    first fsync error, raised by the caller only after all are closed."""
    fsync_err: OSError | None = None
    for fd in fds:
        try:
            if durable and ok and not pipe.errors:
                try:
                    os.fsync(fd)
                except OSError as e:
                    if fsync_err is None:
                        fsync_err = e
            os.close(fd)
        except OSError:
            pass
    return fsync_err


def _remove_all(paths) -> None:
    for p in paths:
        try:
            os.remove(p)
        except OSError:
            pass


def _charge(busy: dict, lock: threading.Lock, key: str, dt) -> None:
    """Accumulate per-stage busy thread-seconds (or counts) across pool
    threads."""
    with lock:
        busy[key] += dt


def _new_busy() -> dict:
    return {
        "read_s": 0.0,
        "stage_s": 0.0,
        "device_s": 0.0,
        "writeback_s": 0.0,
        "compute_s": 0.0,
        "write_s": 0.0,
        # shard rows checksummed on the host because the stage pair
        # declined the fused device CRC (odd tail tiles)
        "host_crc_rows": 0,
    }


# --- host codec stage factories ---------------------------------------------


def local_encode_fns(rs, want_crcs: bool = False) -> tuple[Callable, Callable]:
    """(parity_fn, fetch_fn) over a host ReedSolomon backend: parity_fn
    hands the tile through and fetch_fn runs the matrix apply in the
    writer pool (charged to compute_s). want_crcs=True makes fetch_fn
    return (parity, [k+p] CRC-32C) pairs, the fused-CRC contract."""
    if want_crcs:

        def fetch_fn(tile: np.ndarray):
            return rs.parity_with_crc(tile)

    else:

        def fetch_fn(tile: np.ndarray):
            return rs._apply(rs.parity_rows, tile)

    fetch_fn.charges = "compute_s"
    return (lambda tile: tile), fetch_fn


def local_rebuild_fns(rs, want_crcs: bool = False) -> tuple[Callable, Callable]:
    """(rebuild_fn, fetch_fn) over a host ReedSolomon backend, decode
    deferred to the writer pool (see local_encode_fns)."""

    def rebuild_fn(survivors, targets, tile: np.ndarray):
        return (tuple(survivors), tuple(targets), tile)

    if want_crcs:
        from seaweedfs_tpu_torch.util.crc import crc32c

        def fetch_fn(handle):
            survivors, targets, tile = handle
            rebuilt = rs._apply(rs.decode_rows(survivors, targets), tile)
            return rebuilt, [crc32c(np.ascontiguousarray(r)) for r in rebuilt]

    else:

        def fetch_fn(handle):
            survivors, targets, tile = handle
            return rs._apply(rs.decode_rows(survivors, targets), tile)

    fetch_fn.charges = "compute_s"
    return rebuild_fn, fetch_fn


# --- encode driver ----------------------------------------------------------


def stream_write_ec_files(
    base_file_name: str,
    tile_bytes: int | None = None,
    large_block_size: int = LARGE_BLOCK_SIZE,
    small_block_size: int = SMALL_BLOCK_SIZE,
    parity_fn: Callable[[np.ndarray], "object"] | None = None,
    fetch_fn: Callable[["object"], np.ndarray] | None = None,
    stats: dict | None = None,
    durable: bool = False,
    want_crcs: bool = False,
    device=None,
) -> None:
    """Pipelined .dat → .ec00…13, byte-identical to the classic loop.

    parity_fn([10, step] u8 host tile) dispatches the parity computation
    and returns a handle at once; fetch_fn turns it into a [4, step] u8
    array, or a ([4, step] u8, [14] CRC-32C) pair when the stage fused
    the shard CRCs (called from the writer pool). The default pair runs
    K1 and K4 on `device` (the card unless the caller asks for the CPU).

    durable=True fsyncs every shard fd before returning. want_crcs=True
    lands a 14-entry `shard_crcs` list in `stats`: the CRC-32C of every
    finished shard file, folded from per-tile CRCs; tiles whose stage
    declined the fused CRC are checksummed in the writer pool and
    counted in stats["host_crc_rows"]."""
    if (parity_fn is None) != (fetch_fn is None):
        raise ValueError("parity_fn and fetch_fn must be injected together")
    if parity_fn is None:
        parity_fn, fetch_fn = _cuda_encode_fns(want_crcs=want_crcs, device=device)
    tile_bytes = tile_bytes or DEFAULT_TILE_BYTES
    writer_threads = DEFAULT_WRITER_THREADS
    reader_threads = DEFAULT_READER_THREADS
    depth = pipeline_depth()

    dat_path = base_file_name + ".dat"
    dat_size = os.path.getsize(dat_path)
    from seaweedfs_tpu_torch.ec.ec_files import iter_ec_tiles, to_ext

    # tiles and their shard-file output offsets, precomputed; runs of
    # full-row tiles merge into super-tiles of up to tile_bytes per shard
    tiles: list[tuple[int, int, int, int, int]] = []  # (row_off, block, batch_off, step, rows)
    for row_off, block, batch_off, step in iter_ec_tiles(
        dat_size, tile_bytes, large_block_size, small_block_size
    ):
        if tiles and batch_off == 0 and step == block:
            p_off, p_block, p_batch, p_step, p_rows = tiles[-1]
            if (
                p_batch == 0
                and p_step == p_block == block
                and p_off + p_rows * block * DATA_SHARDS == row_off
                and (p_rows + 1) * block <= tile_bytes
            ):
                tiles[-1] = (p_off, p_block, 0, p_step, p_rows + 1)
                continue
        tiles.append((row_off, block, batch_off, step, 1))
    out_offs, shard_bytes = [], 0
    for _, _, _, step, rows in tiles:
        out_offs.append(shard_bytes)
        shard_bytes += step * rows

    out_fds: list[int] = []  # opened inside the try: no leak on ENOSPC
    pipe = _Pipeline()
    read_q: queue.Queue = queue.Queue(maxsize=max(2, reader_threads))
    write_q: queue.Queue = queue.Queue(maxsize=depth)
    ring = _StagingRing(
        depth + writer_threads + 1,
        DATA_SHARDS * tile_bytes,
        pinned=getattr(parity_fn, "pinned", False),
    )
    busy = _new_busy()
    busy_lock = threading.Lock()
    fetch_bucket = getattr(fetch_fn, "charges", "writeback_s")
    tile_crcs: list = [None] * len(tiles)
    wall0 = time.perf_counter()
    _sp = trace.span("ec_stream.encode", nbytes=dat_size)
    _sp.__enter__()

    idx_lock = threading.Lock()
    idx_iter = iter(range(len(tiles)))

    def reader():
        fd = os.open(dat_path, os.O_RDONLY)
        try:
            while True:
                with idx_lock:
                    k = next(idx_iter, None)
                if k is None:
                    return
                row_off, block, batch_off, step, rows = tiles[k]
                got_slot = ring.acquire(pipe.stop)
                if got_slot is None:
                    return
                slot_id, buf = got_slot
                t0 = time.perf_counter()
                # one flat [rows, 10, step] ring-slot prefix per tile,
                # zero-padded past EOF like the classic reader
                flat = buf[: rows * DATA_SHARDS * step]
                if batch_off == 0 and step == block:
                    # full rows are contiguous in the .dat: one read
                    n = max(0, min(len(flat), dat_size - row_off))
                    if n < len(flat):
                        flat[n:] = 0
                    if n:
                        got = _pread_into(fd, flat[:n], row_off)
                        if got < n:  # truncated .dat: pad like classic
                            flat[got:n] = 0
                else:
                    # sub-block tile of the large tier: rows == 1, shard
                    # blocks strided through the .dat
                    for i in range(DATA_SHARDS):
                        row = flat[i * step : (i + 1) * step]
                        off = row_off + i * block + batch_off
                        n = max(0, min(step, dat_size - off))
                        if n < step:
                            row[n:] = 0
                        if n:
                            got = _pread_into(fd, row[:n], off)
                            if got < n:
                                row[got:n] = 0
                _charge(busy, busy_lock, "read_s", time.perf_counter() - t0)
                if not _q_put(read_q, (k, slot_id, flat), pipe.stop):
                    ring.release(slot_id)
                    return
        finally:
            os.close(fd)

    def writer():
        from seaweedfs_tpu_torch.util.crc import crc32c

        while True:
            item = _q_get(write_q, pipe.stop)
            if item is _EOF or item is _STOPPED:
                return
            k, slot_id, flat, handles = item
            _, _, _, step, rows = tiles[k]
            off = out_offs[k]
            t0 = time.perf_counter()
            parities, crc_rows = [], []
            for h in handles:
                got = fetch_fn(h)
                if isinstance(got, tuple):
                    parities.append(got[0])
                    crc_rows.append(got[1])
                else:
                    parities.append(got)
                    crc_rows.append(None)
            t1 = time.perf_counter()
            host_rows = 0
            if want_crcs and any(c is None for c in crc_rows):
                # the stage declined the fused CRC for this tile
                for r, c in enumerate(crc_rows):
                    if c is not None:
                        continue
                    row0 = r * DATA_SHARDS * step
                    crc_rows[r] = [
                        crc32c(flat[row0 + i * step : row0 + (i + 1) * step])
                        for i in range(DATA_SHARDS)
                    ] + [
                        crc32c(np.ascontiguousarray(parities[r][p]))
                        for p in range(PARITY_SHARDS)
                    ]
                    host_rows += TOTAL_SHARDS
            t2 = time.perf_counter()
            for i in range(DATA_SHARDS):
                _pwritev_full(
                    out_fds[i],
                    [
                        flat[
                            (r * DATA_SHARDS + i) * step : (r * DATA_SHARDS + i + 1)
                            * step
                        ]
                        for r in range(rows)
                    ],
                    off,
                )
            for p in range(PARITY_SHARDS):
                _pwritev_full(
                    out_fds[DATA_SHARDS + p],
                    [np.ascontiguousarray(parities[r][p]) for r in range(rows)],
                    off,
                )
            t3 = time.perf_counter()
            if want_crcs:
                tile_crcs[k] = crc_rows
            ring.release(slot_id)
            _charge(busy, busy_lock, fetch_bucket, t1 - t0)
            _charge(busy, busy_lock, "compute_s", t2 - t1)
            _charge(busy, busy_lock, "write_s", t3 - t2)
            _charge(busy, busy_lock, "host_crc_rows", host_rows)

    ok = False
    try:
        for i in range(TOTAL_SHARDS):
            out_fds.append(
                os.open(
                    base_file_name + to_ext(i),
                    os.O_WRONLY | os.O_CREAT | os.O_TRUNC,
                    0o644,
                )
            )
        for fd in out_fds:
            _preallocate(fd, shard_bytes)
        for _ in range(reader_threads):
            pipe.spawn(reader)
        for _ in range(writer_threads):
            pipe.spawn(writer)
        for _ in range(len(tiles)):
            item = _q_get(read_q, pipe.stop)
            if item is _STOPPED:
                break
            k, slot_id, flat = item
            _, _, _, step, rows = tiles[k]
            t0 = time.perf_counter()
            views = [
                flat[
                    r * DATA_SHARDS * step : (r + 1) * DATA_SHARDS * step
                ].reshape(DATA_SHARDS, step)
                for r in range(rows)
            ]
            t1 = time.perf_counter()
            handles = [parity_fn(v) for v in views]  # one dispatch per row
            t2 = time.perf_counter()
            _charge(busy, busy_lock, "stage_s", t1 - t0)
            _charge(busy, busy_lock, "device_s", t2 - t1)
            if not _q_put(write_q, (k, slot_id, flat, handles), pipe.stop):
                break
        for _ in range(writer_threads):
            if not _q_put(write_q, _EOF, pipe.stop):
                break
        ok = True
    finally:
        try:
            pipe.finish(caller_error=not ok)  # may re-raise a stage error
        finally:
            tc0 = time.perf_counter()
            fsync_err: OSError | None = None
            try:
                fsync_err = _close_and_sync(out_fds, durable, ok, pipe)
                if not ok or pipe.errors or fsync_err is not None:
                    # a partial shard set must not survive the abort
                    _remove_all(base_file_name + to_ext(i) for i in range(TOTAL_SHARDS))
                if fsync_err is not None:
                    raise fsync_err
            finally:
                busy["flush_s"] = time.perf_counter() - tc0
                if stats is not None:
                    _finish_stats(
                        stats, busy, wall0, reader_threads, writer_threads
                    )
                    stats["pipeline_depth"] = depth
                    stats.update(ring.stats())
                    if want_crcs and ok and not pipe.errors and fsync_err is None:
                        stats["shard_crcs"] = _fold_encode_crcs(tiles, tile_crcs)
                _trace_stages(_sp, busy)
                _sp.__exit__(*sys.exc_info())


def _fold_encode_crcs(tiles: list, tile_crcs: list) -> list[int]:
    """Whole-shard-file CRC-32C per shard from the per-tile row CRCs,
    folded in generation order with crc32c_combine."""
    from seaweedfs_tpu_torch.util.crc import crc32c_combine

    crcs = [0] * TOTAL_SHARDS
    for k, (_, _, _, step, rows) in enumerate(tiles):
        per_rows = tile_crcs[k]
        for r in range(rows):
            row = per_rows[r]
            for i in range(TOTAL_SHARDS):
                crcs[i] = crc32c_combine(crcs[i], int(row[i]), step)
    return crcs


# --- rebuild driver ---------------------------------------------------------


def stream_rebuild_ec_files(
    base_file_name: str,
    tile_bytes: int | None = None,
    rebuild_fn: Callable[[tuple[int, ...], tuple[int, ...], np.ndarray], "object"]
    | None = None,
    fetch_fn: Callable[["object"], np.ndarray] | None = None,
    stats: dict | None = None,
    remote_readers: dict[int, Callable[[int, int], bytes]] | None = None,
    session=None,
    durable: bool = False,
    want_crcs: bool = False,
    device=None,
) -> list[int]:
    """Pipelined rebuild of the missing local shard files, byte-identical
    to the classic loop. Returns the rebuilt shard ids.

    rebuild_fn(survivors, targets, [10, step] u8) dispatches the
    reconstruction and returns a handle; fetch_fn blocks it into
    [len(targets), step] u8, or a (bytes, [len(targets)] CRC-32C) pair
    when the stage fused the CRC. The default pair runs K1 and K4 on
    `device`. want_crcs=True lands {shard id: whole-file CRC-32C} in
    stats["shard_crcs"] (device-fused where the stage supports the
    shape; host CRC for donated ranges and odd tails).

    remote_readers maps shard id → fetch(offset, size) -> bytes for
    survivors that live on OTHER nodes: the reader pool pulls their
    spans in parallel with the local preads, and shards readable
    remotely are treated as present (not rebuilt). At least one
    survivor must be local — its file size fixes the tile walk.

    `session` (an ec.repair_session.RebuildSession) consumes the tiles
    degraded serving already decoded as donations: the readers gather
    survivors only for the GAPS, and yield to in-flight degraded
    gathers between tiles. Survivor bytes gathered are counted
    local-vs-remote on weed_ec_repair_bytes_read_total, rebuilt bytes
    written on weed_ec_repair_bytes_written_total."""
    if (rebuild_fn is None) != (fetch_fn is None):
        raise ValueError("rebuild_fn and fetch_fn must be injected together")
    if rebuild_fn is None:
        rebuild_fn, fetch_fn = _cuda_rebuild_fns(want_crcs=want_crcs, device=device)
    # local rebuilds want fine tiles (more in-flight preads to overlap);
    # remote gathers a big one (one fetch per remote survivor a tile)
    tile_bytes = tile_bytes or (
        4 * DEFAULT_TILE_BYTES if remote_readers else DEFAULT_TILE_BYTES // 2
    )
    writer_threads = DEFAULT_WRITER_THREADS
    reader_threads = DEFAULT_READER_THREADS
    depth = pipeline_depth()
    remote_readers = dict(remote_readers or {})

    from seaweedfs_tpu_torch.ec.ec_files import shard_presence, to_ext

    present, local_missing = shard_presence(base_file_name)
    local_ids = [i for i, p in enumerate(present) if p]
    # a shard readable remotely exists in the cluster: it can serve as
    # a survivor but must not be rebuilt here
    targets = tuple(i for i in local_missing if i not in remote_readers)
    if not targets:
        return []
    remote_ids = [i for i in remote_readers if not present[i]]
    if len(local_ids) + len(remote_ids) < DATA_SHARDS:
        raise ValueError(
            "too few shard files to rebuild: "
            f"{len(local_ids) + len(remote_ids)} of {DATA_SHARDS}"
        )
    if not local_ids:
        raise ValueError(
            "rebuild needs at least one local survivor (its size fixes "
            "the shard length)"
        )
    # prefer local survivors (free reads), top up from remote holders;
    # any 10-of-14 subset reconstructs identical bytes
    survivors = tuple(sorted((local_ids + sorted(remote_ids))[:DATA_SHARDS]))
    shard_size = os.path.getsize(base_file_name + to_ext(local_ids[0]))

    out_fds: dict[int, int] = {}  # opened inside the try: no leak on ENOSPC
    pipe = _Pipeline()
    read_q: queue.Queue = queue.Queue(maxsize=max(2, reader_threads))
    write_q: queue.Queue = queue.Queue(maxsize=depth)
    # gap gathers sub-allocate contiguous [k, g_len] views out of one
    # flat slot per tile
    ring = _StagingRing(
        depth + writer_threads + 1,
        DATA_SHARDS * tile_bytes,
        pinned=getattr(rebuild_fn, "pinned", False),
    )
    busy = _new_busy()
    busy_lock = threading.Lock()
    fetch_bucket = getattr(fetch_fn, "charges", "writeback_s")
    # (range offset, range length, [crc per target]) from the writer pool
    crc_ranges: list[tuple[int, int, list[int]]] = []
    wall0 = time.perf_counter()
    _sp = trace.span("ec_stream.rebuild", nbytes=shard_size * len(targets))
    _sp.__enter__()

    offsets = list(range(0, shard_size, tile_bytes))
    idx_lock = threading.Lock()
    idx_iter = iter(offsets)

    n_remote = sum(1 for i in survivors if not present[i])
    read_local = EC_REPAIR_BYTES_READ.labels("local")
    read_remote = EC_REPAIR_BYTES_READ.labels("remote")

    def reader():
        fds = {
            i: os.open(base_file_name + to_ext(i), os.O_RDONLY)
            for i in survivors
            if present[i]
        }
        # remote survivor fetches fan out per tile: serialized, one
        # slow holder would stall the whole tile walk
        fetch_pool = (
            ThreadPoolExecutor(max_workers=min(n_remote, DATA_SHARDS))
            if n_remote > 1
            else None
        )

        def gather(g_off: int, g_len: int, dest: np.ndarray) -> np.ndarray:
            """One [k, g_len] survivor read at g_off into a staging-ring
            view — the only place rebuild bytes cross a disk or the
            network, so the repair accounting lives here."""
            tile = dest.reshape(DATA_SHARDS, g_len)
            futures = {}
            if fetch_pool is not None:
                futures = {
                    j: fetch_pool.submit(remote_readers[i], g_off, g_len)
                    for j, i in enumerate(survivors)
                    if i not in fds
                }
            for j, i in enumerate(survivors):
                if i in fds:
                    got = _pread_into(fds[i], tile[j], g_off)
                    read_local.inc(got)
                else:
                    fut = futures.get(j)
                    raw = (
                        fut.result()
                        if fut is not None
                        else remote_readers[i](g_off, g_len)
                    )
                    got = len(raw)
                    read_remote.inc(got)
                    if got == g_len:
                        tile[j] = np.frombuffer(raw, dtype=np.uint8)
                if got != g_len:
                    raise ValueError(
                        f"ec shard {i} truncated: expected {g_len} at {g_off}"
                    )
            return tile

        try:
            while True:
                with idx_lock:
                    offset = next(idx_iter, None)
                if offset is None:
                    return
                if session is not None:
                    # serve-first: degraded gathers in flight own the
                    # disks and links; repair waits (bounded)
                    session.yield_to_serving()
                step = min(tile_bytes, shard_size - offset)
                if session is not None:
                    covered, gaps = session.consume(offset, step)
                else:
                    covered, gaps = [], [(offset, step)]
                slot_id = -1
                if gaps:
                    got_slot = ring.acquire(pipe.stop)
                    if got_slot is None:
                        return
                    slot_id, buf = got_slot
                t0 = time.perf_counter()
                # parts: ("don", off, {target: bytes}) ride through as
                # bytes; ("raw", off, [k, n] tile) get decoded. Only the
                # gaps pay survivor reads, out of the tile's ring slot
                # (Σ gap bytes ≤ step, so they fit).
                parts: list = [("don", d_off, per_t) for d_off, per_t in covered]
                cur = 0
                for g_off, g_len in gaps:
                    dest = buf[cur : cur + DATA_SHARDS * g_len]
                    cur += DATA_SHARDS * g_len
                    parts.append(("raw", g_off, gather(g_off, g_len, dest)))
                _charge(busy, busy_lock, "read_s", time.perf_counter() - t0)
                if not _q_put(read_q, (offset, slot_id, parts), pipe.stop):
                    if slot_id >= 0:
                        ring.release(slot_id)
                    return
        finally:
            if fetch_pool is not None:
                # in-flight remote fetches finish before the rebuild
                # returns: the caller closes the reader channels then
                fetch_pool.shutdown(wait=True, cancel_futures=True)
            for fd in fds.values():
                os.close(fd)

    def writer():
        from seaweedfs_tpu_torch.util.crc import crc32c

        while True:
            item = _q_get(write_q, pipe.stop)
            if item is _EOF or item is _STOPPED:
                return
            _offset, slot_id, parts = item
            t0 = time.perf_counter()
            fetched = []
            for kind, off, payload in parts:
                crcs = None
                if kind == "h":
                    payload = fetch_fn(payload)
                    if isinstance(payload, tuple):
                        payload, crcs = payload
                fetched.append((kind, off, payload, crcs))
            t1 = time.perf_counter()
            host_rows = 0
            if want_crcs:
                # donated ranges and declined-fused tiles: CRC the bytes
                # being written on the host, charged as compute
                filled = []
                for kind, off, payload, crcs in fetched:
                    if crcs is None:
                        if kind == "don":
                            crcs = [crc32c(payload[i]) for i in targets]
                        else:
                            crcs = [
                                crc32c(np.ascontiguousarray(payload[j]))
                                for j in range(len(targets))
                            ]
                        host_rows += len(targets)
                    filled.append((kind, off, payload, crcs))
                fetched = filled
            t2 = time.perf_counter()
            for kind, off, payload, crcs in fetched:
                length = 0
                if kind == "don":
                    for i in targets:
                        _pwrite_full(out_fds[i], payload[i], off)
                        EC_REPAIR_BYTES_WRITTEN.inc(len(payload[i]))
                        length = len(payload[i])
                else:
                    for j, i in enumerate(targets):
                        row = np.ascontiguousarray(payload[j])
                        _pwrite_full(out_fds[i], row, off)
                        EC_REPAIR_BYTES_WRITTEN.inc(len(row))
                        length = len(row)
                if want_crcs:
                    crc_ranges.append((off, length, [int(c) for c in crcs]))
            t3 = time.perf_counter()
            if slot_id >= 0:
                ring.release(slot_id)
            _charge(busy, busy_lock, fetch_bucket, t1 - t0)
            _charge(busy, busy_lock, "compute_s", t2 - t1)
            _charge(busy, busy_lock, "write_s", t3 - t2)
            _charge(busy, busy_lock, "host_crc_rows", host_rows)

    ok = False
    try:
        for i in targets:
            out_fds[i] = os.open(
                base_file_name + to_ext(i),
                os.O_WRONLY | os.O_CREAT | os.O_TRUNC,
                0o644,
            )
        for fd in out_fds.values():
            _preallocate(fd, shard_size)
        for _ in range(reader_threads):
            pipe.spawn(reader)
        for _ in range(writer_threads):
            pipe.spawn(writer)
        for _ in range(len(offsets)):
            item = _q_get(read_q, pipe.stop)
            if item is _STOPPED:
                break
            offset, slot_id, parts = item
            t0 = time.perf_counter()
            parts = [
                (
                    ("h", off, rebuild_fn(survivors, targets, payload))
                    if kind == "raw"
                    else (kind, off, payload)
                )
                for kind, off, payload in parts
            ]
            _charge(busy, busy_lock, "device_s", time.perf_counter() - t0)
            if not _q_put(write_q, (offset, slot_id, parts), pipe.stop):
                break
        for _ in range(writer_threads):
            if not _q_put(write_q, _EOF, pipe.stop):
                break
        ok = True
    finally:
        try:
            pipe.finish(caller_error=not ok)  # may re-raise a stage error
        finally:
            tc0 = time.perf_counter()
            fsync_err: OSError | None = None
            try:
                fsync_err = _close_and_sync(out_fds.values(), durable, ok, pipe)
                if not ok or pipe.errors or fsync_err is not None:
                    # half-written targets must not survive: a later
                    # shard_presence would count them as valid shards
                    _remove_all(base_file_name + to_ext(i) for i in targets)
                if fsync_err is not None:
                    raise fsync_err
            finally:
                busy["flush_s"] = time.perf_counter() - tc0
                if stats is not None:
                    _finish_stats(
                        stats, busy, wall0, reader_threads, writer_threads
                    )
                    stats["pipeline_depth"] = depth
                    stats.update(ring.stats())
                    if want_crcs and ok and not pipe.errors and fsync_err is None:
                        stats["shard_crcs"] = _fold_rebuild_crcs(targets, crc_ranges)
                    if session is not None:
                        stats["donated_bytes"] = session.donated_bytes
                        stats["used_donated_bytes"] = session.used_donated_bytes
                        stats["serve_yields"] = session.yields
                _trace_stages(_sp, busy)
                if session is not None:
                    _sp.annotate("donated_bytes", session.used_donated_bytes)
                    _sp.annotate("serve_yields", session.yields)
                _sp.__exit__(*sys.exc_info())
    return list(targets)


def _fold_rebuild_crcs(
    targets: tuple[int, ...], crc_ranges: list[tuple[int, int, list[int]]]
) -> dict[int, int]:
    """{target shard id: whole-file CRC-32C} from per-range CRCs (sorted
    by offset, folded with crc32c_combine)."""
    from seaweedfs_tpu_torch.util.crc import crc32c_combine

    acc = {i: 0 for i in targets}
    for _off, length, crcs in sorted(crc_ranges, key=lambda r: r[0]):
        for j, i in enumerate(targets):
            acc[i] = crc32c_combine(acc[i], crcs[j], length)
    return acc


def _trace_stages(sp, busy: dict) -> None:
    """The driver's busy thread-seconds as the three stages an operator
    reasons about: reader-pool, compute, writer-pool."""
    sp.add_stages(
        {
            "reader-pool": busy.get("read_s", 0.0),
            "compute": (
                busy.get("stage_s", 0.0)
                + busy.get("device_s", 0.0)
                + busy.get("writeback_s", 0.0)
                + busy.get("compute_s", 0.0)
            ),
            "writer-pool": busy.get("write_s", 0.0),
        }
    )


def _finish_stats(
    stats: dict,
    busy: dict,
    wall0: float,
    reader_threads: int = 1,
    writer_threads: int = 1,
) -> None:
    """Per-stage busy thread-seconds, wall, the unattributed remainder
    (loop_s = wall − flush − the largest per-thread stage share) and
    overlap_s (busy seconds beyond wall: proof the stages overlapped)."""
    wall = time.perf_counter() - wall0
    flush = busy.get("flush_s", 0.0)
    widths = {
        "read_s": reader_threads,
        "writeback_s": writer_threads,
        "compute_s": writer_threads,
        "write_s": writer_threads,
    }
    timed = {k: v for k, v in busy.items() if k.endswith("_s") and k != "flush_s"}
    pipeline_max = max(
        (v / widths.get(k, 1) for k, v in timed.items()), default=0.0
    )
    stats.update({k: round(v, 4) for k, v in busy.items() if k.endswith("_s")})
    stats["host_crc_rows"] = int(busy.get("host_crc_rows", 0))
    stats["wall_s"] = round(wall, 4)
    stats["loop_s"] = round(max(0.0, wall - flush - pipeline_max), 4)
    stats["overlap_s"] = round(max(0.0, sum(timed.values()) - (wall - flush)), 4)
    stats["reader_threads"] = reader_threads
    stats["writer_threads"] = writer_threads


# --- default CUDA kernel stages --------------------------------------------


def _crc_ok(step: int, want_crcs: bool) -> bool:
    from seaweedfs_tpu_torch.ec import crc_kernel

    return want_crcs and crc_kernel.crc_supported(step)


class _CudaStage:
    """Shared mechanics of the CUDA stage pairs: stage a host tile on
    the device, run the kernels, start the D2H, and hand back an
    `(out, swar, fused_crc)` handle whose `out` carries an event.

    On the card every step is enqueued on one side stream and the
    dispatcher returns at once; the writer pool's _fetch waits on the
    event. On device="cpu" the plain versions run synchronously and
    the event is None."""

    def __init__(self, device):
        from seaweedfs_tpu_torch.ec.codec_cuda import CudaCodecKernels

        self.kern = CudaCodecKernels(DATA_SHARDS, PARITY_SHARDS, device)
        self.device = self.kern.device
        self.cuda = self.device.type == "cuda"
        self.stream = torch.cuda.Stream(self.device) if self.cuda else None

    def run(
        self, tile: np.ndarray, fused_crc: bool, compute, tile_rows: int = DATA_SHARDS
    ):
        """compute(x_dev [tile_rows, n32] int32, the host tile in its
        first 10 rows) -> (out [r, n32], crcs|None)."""
        step = tile.shape[1]
        n32 = -(-step // 4)
        if step % 4 or not tile.flags.c_contiguous:
            padded = np.zeros((tile.shape[0], n32 * 4), dtype=np.uint8)
            padded[:, :step] = tile
            tile = padded
        host = torch.from_numpy(tile.view(np.int32))
        with torch.cuda.stream(self.stream) if self.cuda else contextlib.nullcontext():
            if tile_rows == DATA_SHARDS:
                x = host.to(self.device, non_blocking=True)
            else:
                x = torch.empty((tile_rows, n32), dtype=torch.int32, device=self.device)
                x[:DATA_SHARDS].copy_(host, non_blocking=True)
            out, crcs = compute(x)
            if not self.cuda:
                return (out.numpy(), None if crcs is None else crcs.numpy(), None, step)
            out_h = torch.empty(out.shape, dtype=torch.int32, pin_memory=True)
            out_h.copy_(out, non_blocking=True)
            crcs_h = None
            if crcs is not None:
                crcs_h = torch.empty(crcs.shape, dtype=torch.int32, pin_memory=True)
                crcs_h.copy_(crcs, non_blocking=True)
            ev = torch.cuda.Event()
            ev.record(self.stream)
            # the staging tile (a ring slot) and the device tensors stay
            # referenced by the handle until the event has fired
            return (out_h.numpy(), None if crcs_h is None else crcs_h.numpy(),
                    (ev, x, out, crcs, out_h, crcs_h, host), step)


def _fetch(handle):
    """Wait for a dispatched tile and return [r, step] uint8, or
    (uint8 array, uint32 CRC array) when the dispatch fused the CRC
    pass (the driver splits on the tuple)."""
    out, _swar, fused_crc = handle
    out_np, crcs_np, keep, step = out
    if keep is not None:
        keep[0].synchronize()
    host = out_np.view(np.uint8)[:, :step]
    if fused_crc:
        return host, crcs_np.view(np.uint32)
    return host


def _cuda_encode_fns(want_crcs: bool = False, device=None):
    """(parity_fn, fetch_fn) running K1 (+ K4 when the CRCs are wanted
    and the tile shape allows) on `device`."""
    stage = _CudaStage(device)
    kern = stage.kern

    def parity_fn(tile: np.ndarray):
        fused_crc = _crc_ok(tile.shape[1], want_crcs)
        if fused_crc:
            # one [14, n32] device tile: K1 fills the parity rows, one K4
            # launch checksums all 14, and only the parity rows come back
            out = stage.run(
                tile, True, lambda x: (x[DATA_SHARDS:], kern.encode_tile_crc(x)),
                tile_rows=TOTAL_SHARDS,
            )
        else:
            out = stage.run(tile, False, lambda x: (kern.encode_u32(x), None))
        return out, True, fused_crc

    parity_fn.pinned = stage.cuda
    return parity_fn, _fetch


def _cuda_rebuild_fns(want_crcs: bool = False, device=None):
    """(rebuild_fn, fetch_fn) running K1 with decode rows (+ K4)."""
    stage = _CudaStage(device)
    kern = stage.kern

    def rebuild_fn(survivors, targets, tile: np.ndarray):
        s, t = tuple(survivors), tuple(targets)
        fused_crc = _crc_ok(tile.shape[1], want_crcs)
        if fused_crc:
            out = stage.run(
                tile, True, lambda x: kern.reconstruct_u32_crc(s, t, x)
            )
        else:
            out = stage.run(
                tile, False, lambda x: (kern.reconstruct_u32(s, t, x), None)
            )
        return out, True, fused_crc

    rebuild_fn.pinned = stage.cuda
    return rebuild_fn, _fetch


# --- batch drivers: N volumes per round through a MeshCodec ----------------


def _read_tile_into(
    fd: int, dat_size: int, row_off: int, block: int, batch_off: int,
    step: int, dest: np.ndarray,
) -> None:
    """Fill dest [10, step] (ring-slot views) with one volume's tile of
    the .dat, zero-padded past EOF — the batch reader's striping math
    (the layout the single-volume reader inlines). Per-row reads even
    for full rows: dest rows are strided views of the batch slot."""
    for i in range(DATA_SHARDS):
        row = dest[i]
        off = row_off + i * block + batch_off
        n = max(0, min(step, dat_size - off))
        if n < step:
            row[n:] = 0
        if n:
            got = _pread_into(fd, row[:n], off)
            if got < n:
                row[got:n] = 0


def _default_mesh_codec(batch: int, devices=None, matrix=None):
    """MeshCodec over `devices` (default: every card; raises without
    one) with the 'vol' axis sized to gcd(batch, devices), so any batch
    shards cleanly."""
    import math

    from seaweedfs_tpu_torch.parallel import MeshCodec, make_mesh
    from seaweedfs_tpu_torch.parallel.mesh_codec import cuda_devices

    devices = list(devices) if devices is not None else cuda_devices()
    vol_axis = math.gcd(batch, len(devices))
    return MeshCodec(make_mesh(devices, stripe=len(devices) // vol_axis), matrix=matrix)


def _resized_codec(codec, batch: int):
    """A mesh sized to a chunk of `batch` volumes, over `codec`'s
    devices and code matrix (every card when codec is None) — where the
    reference provisions one over all of its devices."""
    if codec is None:
        return _default_mesh_codec(batch)
    return _default_mesh_codec(batch, list(codec.mesh.devices.flat), codec.matrix)


def _merge_chunk_stats(stats: dict, chunk_stats: dict) -> None:
    """Fold one chunk's stats into the whole run's: stage seconds and
    host CRC rows add up, ring_bytes keeps the largest (chunks run one
    after another), other structural fields keep the last chunk's."""
    for k, v in chunk_stats.items():
        if k == "shard_crcs":
            continue
        if isinstance(v, float) or k == "host_crc_rows":
            stats[k] = round(stats.get(k, 0) + v, 4)
        elif k == "ring_bytes":
            stats[k] = max(stats.get(k, 0), v)
        else:
            stats[k] = v


class _MeshStage:
    """The batch drivers' device side around a MeshCodec. On the card
    each round's H2D copies, kernels and D2H copies are enqueued on one
    side stream per device and the dispatcher returns at once with
    HostFetch handles; the writer pool's wait() blocks on the round's
    events. On CPU devices the plain versions run synchronously."""

    def __init__(self, codec):
        self.codec = codec
        self.streams = [
            torch.cuda.Stream(d) for d in codec.devices if d.type == "cuda"
        ]
        self.pinned = bool(self.streams)

    def _enqueue(self, fn):
        with contextlib.ExitStack() as stack:
            for s in self.streams:
                stack.enter_context(torch.cuda.stream(s))
            return fn()

    def encode(self, buf3: np.ndarray, fused_crc: bool):
        """Dispatch one [B, 10, W] uint8 round: (parity fetch, CRC fetch
        or None). With the fused CRC the data lands in a batch tile with
        room for the parity, so K2 writes the parity beside it, one K4
        launch per device checksums all 14 rows, and the parity comes
        home with one contiguous copy."""
        host = torch.from_numpy(buf3.view(np.int32))
        codec = self.codec

        def run():
            vols = codec.shard_volumes(host, parity_room=fused_crc, non_blocking=True)
            if fused_crc:
                parity, crcs = codec.encode_batch_u32_crc(vols)
                return parity.fetch(), crcs.fetch()
            return codec.encode_batch_u32(vols).fetch(), None

        return self._enqueue(run)

    def rebuild(self, buf3: np.ndarray, survivors, targets):
        """Dispatch one [B, 10, W] uint8 survivor round: rebuilt fetch."""
        host = torch.from_numpy(buf3.view(np.int32))
        codec = self.codec
        return self._enqueue(
            lambda: codec.reconstruct_batch_u32(
                survivors, targets, codec.shard_volumes(host, non_blocking=True)
            ).fetch()
        )


def stream_write_ec_files_batch(
    base_file_names: list[str],
    codec=None,
    tile_bytes: int | None = None,
    large_block_size: int = LARGE_BLOCK_SIZE,
    small_block_size: int = SMALL_BLOCK_SIZE,
    stats: dict | None = None,
    durable: bool = False,
    want_crcs: bool = False,
    reader_threads: int | None = None,
    writer_threads: int | None = None,
) -> None:
    """Pipelined encode of N sealed .dat files into N shard sets through
    a MeshCodec, byte-identical per volume to write_ec_files. Each tile
    round stacks one [10, W] tile per volume into a [B, 10, W/4]-lane
    batch: one K2 launch (plus one K4 launch with the fused CRCs) per
    device per round, where the single-volume driver pays a launch per
    volume. Disk reads, staging, the kernels, the D2H copies and the
    shard pwritevs overlap as in stream_write_ec_files.

    codec=None provisions a MeshCodec over every card, its 'vol' axis
    gcd(batch, cards); it raises without a card (a mesh of CPU devices,
    passed explicitly, runs the kernels' plain versions).
    WEED_EC_PIPELINE_BATCH caps the volumes per round (ring memory =
    slots x batch x 10 x tile bytes); each chunk gets a mesh sized to
    it over the same devices.

    want_crcs=True lands `shard_crcs` in stats: one 14-entry CRC-32C
    list per volume (fused on the device for full-width rounds, host
    CRCs for the tail rounds, counted in host_crc_rows). A failed run
    removes every volume's shard files."""
    if not base_file_names:
        return
    limit = pipeline_batch_limit()
    if limit and len(base_file_names) > limit:
        all_crcs: list = []
        for i in range(0, len(base_file_names), limit):
            chunk = base_file_names[i : i + limit]
            chunk_stats: dict = {}
            # each chunk gets a mesh that fits ITS size: a codec built
            # for the whole batch need not divide a chunk
            _stream_batch_chunk(
                chunk, _resized_codec(codec, len(chunk)), tile_bytes,
                large_block_size, small_block_size, chunk_stats, durable,
                want_crcs, reader_threads, writer_threads,
            )
            if want_crcs:
                all_crcs.extend(chunk_stats.get("shard_crcs", []))
            if stats is not None:
                _merge_chunk_stats(stats, chunk_stats)
        if stats is not None:
            stats["batch_volumes"] = len(base_file_names)
            if want_crcs:
                stats["shard_crcs"] = all_crcs
        return
    if codec is None:
        codec = _default_mesh_codec(len(base_file_names))
    _stream_batch_chunk(
        base_file_names, codec, tile_bytes, large_block_size,
        small_block_size, stats, durable, want_crcs, reader_threads,
        writer_threads,
    )


def _run_batch_rounds(
    bases: list[str],
    codec,
    rounds: int,
    width: int,
    inputs: list[list[str]],
    outputs: list[list[tuple[str, int]]],
    fill: Callable,
    dispatch: Callable,
    write: Callable,
    span: str,
    nbytes: int,
    stats: dict | None,
    durable: bool,
    reader_threads: int,
    writer_threads: int,
) -> None:
    """The pipeline of one batch chunk around the caller's three bodies.

    A reader pool takes rounds in order, each thread with its own fds of
    every volume's `inputs`, and runs fill(fds, r, buf3) into a
    [B, 10, width] ring slot; the dispatcher hands the slot to
    dispatch(stage, buf3) -> handle (a _MeshStage round, returning once
    enqueued); a writer pool runs write(r, buf3, handle, out_fds, charge)
    and frees the slot. out_fds[v] holds volume v's `outputs` (path,
    preallocated size) in order; charge(key, seconds) books stage time.

    It owns the queues, the ring and the pools, and the epilogue: close
    (fsync first when durable), and on any failure remove every
    volume's outputs, so no partial set survives. Fills `stats` with the
    stage seconds and the run's structure."""
    depth = pipeline_depth()
    b = len(bases)
    vol_axis, stripe = codec.mesh.devices.shape
    stage = _MeshStage(codec)
    pipe = _Pipeline()
    read_q: queue.Queue = queue.Queue(maxsize=max(2, reader_threads))
    write_q: queue.Queue = queue.Queue(maxsize=depth)
    ring = _StagingRing(
        depth + writer_threads + 1, b * DATA_SHARDS * width, pinned=stage.pinned
    )
    busy = _new_busy()
    busy_lock = threading.Lock()
    wall0 = time.perf_counter()
    _sp = trace.span(span, nbytes=nbytes)
    _sp.__enter__()

    idx_lock = threading.Lock()
    idx_iter = iter(range(rounds))
    out_fds: list[list[int]] = []

    def charge(key: str, dt) -> None:
        _charge(busy, busy_lock, key, dt)

    def reader():
        fds: list[list[int]] = []
        try:
            for paths in inputs:
                fds.append([])
                for p in paths:
                    fds[-1].append(os.open(p, os.O_RDONLY))
            while True:
                with idx_lock:
                    r = next(idx_iter, None)
                if r is None:
                    return
                got_slot = ring.acquire(pipe.stop)
                if got_slot is None:
                    return
                slot_id, buf = got_slot
                t0 = time.perf_counter()
                buf3 = buf[: b * DATA_SHARDS * width].reshape(b, DATA_SHARDS, width)
                fill(fds, r, buf3)
                charge("read_s", time.perf_counter() - t0)
                if not _q_put(read_q, (r, slot_id, buf3), pipe.stop):
                    ring.release(slot_id)
                    return
        finally:
            for vol_fds in fds:
                for fd in vol_fds:
                    os.close(fd)

    def writer():
        while True:
            item = _q_get(write_q, pipe.stop)
            if item is _EOF or item is _STOPPED:
                return
            r, slot_id, buf3, handle = item
            write(r, buf3, handle, out_fds, charge)
            ring.release(slot_id)

    ok = False
    try:
        for files in outputs:
            fds: list[int] = []
            out_fds.append(fds)
            for path, _ in files:
                fds.append(os.open(path, os.O_WRONLY | os.O_CREAT | os.O_TRUNC, 0o644))
            for fd, (_, size) in zip(fds, files):
                _preallocate(fd, size)
        for _ in range(min(reader_threads, rounds)):
            pipe.spawn(reader)
        for _ in range(writer_threads):
            pipe.spawn(writer)
        for _ in range(rounds):
            item = _q_get(read_q, pipe.stop)
            if item is _STOPPED:
                break
            r, slot_id, buf3 = item
            t0 = time.perf_counter()
            handle = dispatch(stage, buf3)
            charge("device_s", time.perf_counter() - t0)
            if not _q_put(write_q, (r, slot_id, buf3, handle), pipe.stop):
                break
        for _ in range(writer_threads):
            if not _q_put(write_q, _EOF, pipe.stop):
                break
        ok = True
    finally:
        try:
            pipe.finish(caller_error=not ok)
        finally:
            tc0 = time.perf_counter()
            try:
                fsync_err = _close_and_sync(
                    [fd for fds in out_fds for fd in fds], durable, ok, pipe
                )
                if not ok or pipe.errors or fsync_err is not None:
                    # no partial output set may survive for ANY volume
                    _remove_all(path for files in outputs for path, _ in files)
                if fsync_err is not None:
                    raise fsync_err
            finally:
                busy["flush_s"] = time.perf_counter() - tc0
                if stats is not None:
                    _finish_stats(stats, busy, wall0, reader_threads, writer_threads)
                    stats["pipeline_depth"] = depth
                    stats.update(ring.stats())
                    stats["batch_volumes"] = b
                    stats["mesh"] = {"vol": vol_axis, "stripe": stripe}
                _trace_stages(_sp, busy)
                _sp.__exit__(*sys.exc_info())


def _check_vol_axis(b: int, codec) -> None:
    vol_axis = codec.mesh.devices.shape[0]
    if b % vol_axis:
        raise ValueError(
            f"batch of {b} volumes does not shard over the mesh's "
            f"{vol_axis}-way 'vol' axis"
        )


def _stream_batch_chunk(
    bases: list[str], codec, tile_bytes, large_block_size, small_block_size,
    stats, durable, want_crcs, reader_threads, writer_threads,
) -> None:
    from seaweedfs_tpu_torch.ec.ec_files import iter_ec_tiles, shard_file_size, to_ext
    from seaweedfs_tpu_torch.util.crc import crc32c

    tile_bytes = tile_bytes or DEFAULT_TILE_BYTES
    b = len(bases)
    _check_vol_axis(b, codec)
    stripe = codec.mesh.devices.shape[1]

    sizes = [os.path.getsize(base + ".dat") for base in bases]
    tiles = [
        list(iter_ec_tiles(size, tile_bytes, large_block_size, small_block_size))
        for size in sizes
    ]
    rounds = max((len(ts) for ts in tiles), default=0)
    if not rounds:
        # all .dat files empty: 14 empty shard files each, fsynced when
        # durable so a later .ecx publish never outlives them
        from seaweedfs_tpu_torch.util import durable as _durable

        for base in bases:
            for i in range(TOTAL_SHARDS):
                open(base + to_ext(i), "wb").close()
                if durable:
                    _durable.fsync_path(base + to_ext(i))
        if stats is not None and want_crcs:
            stats["shard_crcs"] = [[0] * TOTAL_SHARDS for _ in bases]
        return
    # one tile width for every round (finished volumes ride as zero-step
    # entries whose output is discarded), rounded so the lane count
    # splits over the stripe axis in whole 1024-lane chunks
    max_step = max(step for ts in tiles for _, _, _, step in ts)
    gran = 4 * 1024 * stripe
    width = -(-max_step // gran) * gran
    # the fused CRC needs power-of-two lanes per device (crc_kernel);
    # tail rounds (step < width) are host-checksummed regardless
    fused_crc = want_crcs and codec.crc_supported(width)
    step_of = [[(ts[r][3] if r < len(ts) else 0) for ts in tiles] for r in range(rounds)]
    out_offs = []  # [rounds][volume] output offset
    acc = [0] * b
    for r in range(rounds):
        out_offs.append(list(acc))
        for v in range(b):
            acc[v] += step_of[r][v]
    round_crcs: list = [None] * rounds

    def fill(fds, r, buf3):
        for v in range(b):
            if r >= len(tiles[v]):
                continue  # volume done: zero-step, output discarded
            row_off, block, batch_off, step = tiles[v][r]
            _read_tile_into(
                fds[v][0], sizes[v], row_off, block, batch_off, step, buf3[v, :, :step]
            )

    def write(r, buf3, handle, out_fds, charge):
        parity_f, crcs_f = handle
        t0 = time.perf_counter()
        parity = parity_f.wait().numpy().view(np.uint8)  # [b, 4, width]
        crcs = None if crcs_f is None else crcs_f.wait().numpy().view(np.uint32)
        t1 = time.perf_counter()
        vol_crcs: list = [None] * b
        host_rows = 0
        if want_crcs:
            for v in range(b):
                step = step_of[r][v]
                if not step:
                    continue
                if crcs is not None and step == width:
                    vol_crcs[v] = [int(c) for c in crcs[v]]
                else:
                    # tail round: the fused CRC would cover the padded
                    # width; checksum the written bytes
                    vol_crcs[v] = [
                        crc32c(buf3[v, i, :step]) for i in range(DATA_SHARDS)
                    ] + [crc32c(parity[v, p, :step]) for p in range(PARITY_SHARDS)]
                    host_rows += TOTAL_SHARDS
        t2 = time.perf_counter()
        for v in range(b):
            step = step_of[r][v]
            if not step:
                continue
            off = out_offs[r][v]
            for i in range(DATA_SHARDS):
                _pwrite_full(out_fds[v][i], buf3[v, i, :step], off)
            for p in range(PARITY_SHARDS):
                _pwrite_full(out_fds[v][DATA_SHARDS + p], parity[v, p, :step], off)
        t3 = time.perf_counter()
        if want_crcs:
            round_crcs[r] = vol_crcs
        charge("writeback_s", t1 - t0)
        charge("compute_s", t2 - t1)
        charge("write_s", t3 - t2)
        charge("host_crc_rows", host_rows)

    _run_batch_rounds(
        bases, codec, rounds, width,
        inputs=[[base + ".dat"] for base in bases],
        outputs=[
            [(base + to_ext(i), shard_file_size(size, large_block_size, small_block_size))
             for i in range(TOTAL_SHARDS)]
            for base, size in zip(bases, sizes)
        ],
        fill=fill,
        dispatch=lambda stage, buf3: stage.encode(buf3, fused_crc),
        write=write,
        span="ec_stream.encode_batch",
        nbytes=sum(sizes),
        stats=stats,
        durable=durable,
        reader_threads=reader_threads or DEFAULT_READER_THREADS,
        writer_threads=writer_threads or DEFAULT_WRITER_THREADS,
    )
    if stats is not None and want_crcs:
        stats["shard_crcs"] = _fold_batch_crcs(b, step_of, round_crcs)


def _fold_batch_crcs(b: int, step_of: list[list[int]], round_crcs: list) -> list[list[int]]:
    """Per-volume 14-entry whole-file CRCs from the per-round writer
    records, folded in round order."""
    from seaweedfs_tpu_torch.util.crc import crc32c_combine

    out = []
    for v in range(b):
        acc = [0] * TOTAL_SHARDS
        for r, vol_crcs in enumerate(round_crcs):
            step = step_of[r][v]
            if not step or vol_crcs is None or vol_crcs[v] is None:
                continue
            for i in range(TOTAL_SHARDS):
                acc[i] = crc32c_combine(acc[i], vol_crcs[v][i], step)
        out.append(acc)
    return out


def stream_rebuild_ec_files_batch(
    base_file_names: list[str],
    codec=None,
    tile_bytes: int | None = None,
    stats: dict | None = None,
    durable: bool = False,
    want_crcs: bool = False,
    reader_threads: int | None = None,
    writer_threads: int | None = None,
) -> list[list[int]]:
    """Rebuild N volumes' missing shard files through a MeshCodec, one K2
    launch per device per tile round — the rebuild-side sibling of
    stream_write_ec_files_batch, for the RepairScheduler's common case
    of a node loss leaving many small volumes missing the same shards.

    Volumes are grouped by their (survivors, targets) signature; each
    group runs its own rounds (chunked by WEED_EC_PIPELINE_BATCH), one
    decode matrix each. Every survivor must be local. Output bytes per
    volume equal rebuild_ec_files' (the same ascending survivor choice).
    codec=None provisions a mesh over every card and raises without one.

    want_crcs=True lands `shard_crcs` in stats: one {rebuilt shard id:
    whole-file CRC-32C} dict per volume, in base_file_names order (host
    CRCs of the rebuilt rows, as the reference takes them). Returns the
    per-volume rebuilt id lists; volumes with nothing missing get [].
    durable=True fsyncs every rebuilt shard; a failed chunk removes all
    its volumes' target files."""
    from seaweedfs_tpu_torch.ec.ec_files import shard_presence

    results: list[list[int]] = [[] for _ in base_file_names]
    if not base_file_names:
        return results
    groups: dict[tuple, list[int]] = {}
    for i, base in enumerate(base_file_names):
        present, missing = shard_presence(base)
        targets = tuple(missing)
        if not targets:
            continue
        local_ids = [s for s, p in enumerate(present) if p]
        if len(local_ids) < DATA_SHARDS:
            raise ValueError(
                f"too few local shard files to batch-rebuild {base}: "
                f"{len(local_ids)} of {DATA_SHARDS}"
            )
        # the single-volume driver's ascending first-k survivor choice
        groups.setdefault((tuple(local_ids[:DATA_SHARDS]), targets), []).append(i)

    if not groups:
        if stats is not None:
            stats["batch_volumes"] = len(base_file_names)
            stats["batch_groups"] = 0
            if want_crcs:
                stats["shard_crcs"] = [{} for _ in base_file_names]
        return results
    if codec is None:
        codec = _default_mesh_codec(max(len(idxs) for idxs in groups.values()))

    limit = pipeline_batch_limit()
    crcs_by_vol: dict[int, dict] = {}
    merged: dict = {}
    for (survivors, targets), idxs in groups.items():
        chunks = (
            [idxs[i : i + limit] for i in range(0, len(idxs), limit)] if limit else [idxs]
        )
        for chunk in chunks:
            chunk_stats: dict = {}
            # the caller's codec is honoured when the chunk shards over
            # its vol axis; otherwise a mesh sized to the chunk
            chunk_codec = codec
            if len(chunk) % codec.mesh.devices.shape[0]:
                chunk_codec = _resized_codec(codec, len(chunk))
            _rebuild_batch_chunk(
                [base_file_names[i] for i in chunk], chunk_codec, survivors,
                targets, tile_bytes, chunk_stats, durable, want_crcs,
                reader_threads, writer_threads,
            )
            for i in chunk:
                results[i] = list(targets)
            if want_crcs:
                for i, crcs in zip(chunk, chunk_stats.get("shard_crcs") or []):
                    crcs_by_vol[i] = crcs
            _merge_chunk_stats(merged, chunk_stats)
    if stats is not None:
        stats.update(merged)
        stats["batch_volumes"] = len(base_file_names)
        stats["batch_groups"] = len(groups)
        if want_crcs:
            stats["shard_crcs"] = [crcs_by_vol.get(i, {}) for i in range(len(base_file_names))]
    return results


def _rebuild_batch_chunk(
    bases: list[str], codec, survivors: tuple[int, ...],
    targets: tuple[int, ...], tile_bytes, stats, durable, want_crcs,
    reader_threads, writer_threads,
) -> None:
    """One (survivors, targets)-homogeneous chunk: [k, step] survivor
    tiles per volume into a [B, k, W] ring slot, one reconstruct round
    through the mesh, the rebuilt rows pwritten. Any failure removes
    every volume's target files."""
    from seaweedfs_tpu_torch.ec.ec_files import to_ext
    from seaweedfs_tpu_torch.util.crc import crc32c

    # local rebuilds take the fine tile, as the single-volume driver
    tile_bytes = tile_bytes or DEFAULT_TILE_BYTES // 2
    b = len(bases)
    _check_vol_axis(b, codec)
    stripe = codec.mesh.devices.shape[1]

    sizes = [os.path.getsize(base + to_ext(survivors[0])) for base in bases]
    rounds = max(-(-size // tile_bytes) for size in sizes)
    if not rounds:
        # all-empty shard sets: the rebuilt targets are empty files too
        from seaweedfs_tpu_torch.util import durable as _durable

        for base in bases:
            for t in targets:
                open(base + to_ext(t), "wb").close()
                if durable:
                    _durable.fsync_path(base + to_ext(t))
        if stats is not None:
            stats["batch_volumes"] = b
            if want_crcs:
                stats["shard_crcs"] = [{t: 0 for t in targets} for _ in bases]
        return
    step_of = [
        [max(0, min(tile_bytes, sizes[v] - r * tile_bytes)) for v in range(b)]
        for r in range(rounds)
    ]
    # one tile width for every round, rounded so the lane count splits
    # over the stripe axis in whole 1024-lane chunks
    max_step = max(step for row in step_of for step in row)
    gran = 4 * 1024 * stripe
    width = -(-max_step // gran) * gran
    nt = len(targets)
    round_crcs: list = [None] * rounds
    read_local = EC_REPAIR_BYTES_READ.labels("local")

    def fill(fds, r, buf3):
        off = r * tile_bytes
        for v in range(b):
            step = step_of[r][v]
            if not step:
                continue  # volume done: output discarded
            for j in range(DATA_SHARDS):
                got = _pread_into(fds[v][j], buf3[v, j, :step], off)
                read_local.inc(got)
                if got != step:
                    raise ValueError(
                        f"ec shard {survivors[j]} truncated: expected "
                        f"{step} at {off} ({bases[v] + to_ext(survivors[j])})"
                    )

    def write(r, buf3, fetch, out_fds, charge):
        t0 = time.perf_counter()
        rebuilt = fetch.wait().numpy().view(np.uint8)  # [b, nt, width]
        t1 = time.perf_counter()
        vol_crcs: list = [None] * b
        host_rows = 0
        if want_crcs:
            for v in range(b):
                step = step_of[r][v]
                if step:
                    vol_crcs[v] = [crc32c(rebuilt[v, t, :step]) for t in range(nt)]
                    host_rows += nt
        t2 = time.perf_counter()
        off = r * tile_bytes
        for v in range(b):
            step = step_of[r][v]
            if not step:
                continue
            for t in range(nt):
                _pwrite_full(out_fds[v][t], rebuilt[v, t, :step], off)
                EC_REPAIR_BYTES_WRITTEN.inc(step)
        t3 = time.perf_counter()
        if want_crcs:
            round_crcs[r] = vol_crcs
        charge("writeback_s", t1 - t0)
        charge("compute_s", t2 - t1)
        charge("write_s", t3 - t2)
        charge("host_crc_rows", host_rows)

    _run_batch_rounds(
        bases, codec, rounds, width,
        inputs=[[base + to_ext(s) for s in survivors] for base in bases],
        outputs=[
            [(base + to_ext(t), size) for t in targets] for base, size in zip(bases, sizes)
        ],
        fill=fill,
        dispatch=lambda stage, buf3: stage.rebuild(buf3, survivors, targets),
        write=write,
        span="ec_stream.rebuild_batch",
        nbytes=sum(sizes) * max(1, nt),
        stats=stats,
        durable=durable,
        reader_threads=reader_threads or DEFAULT_READER_THREADS,
        writer_threads=writer_threads or DEFAULT_WRITER_THREADS,
    )
    if stats is not None and want_crcs:
        stats["shard_crcs"] = _fold_rebuild_batch_crcs(b, targets, step_of, round_crcs)


def _fold_rebuild_batch_crcs(
    b: int, targets: tuple[int, ...], step_of: list[list[int]], round_crcs: list
) -> list[dict[int, int]]:
    """Per-volume {rebuilt shard id: whole-file CRC} from the writer
    pool's per-round records, folded in round order."""
    from seaweedfs_tpu_torch.util.crc import crc32c_combine

    out = []
    for v in range(b):
        acc = {tid: 0 for tid in targets}
        for r, vol_crcs in enumerate(round_crcs):
            step = step_of[r][v]
            if not step or vol_crcs is None or vol_crcs[v] is None:
                continue
            for t, tid in enumerate(targets):
                acc[tid] = crc32c_combine(acc[tid], vol_crcs[v][t], step)
        out.append(acc)
    return out
