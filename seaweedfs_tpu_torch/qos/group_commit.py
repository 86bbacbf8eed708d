"""Group commit for the volume write path (docs/QOS.md).

Concurrent POSTs against one volume coalesce into a commit window: the
first writer becomes the window's leader, waits up to `-commitWindowUs`
(or until the byte/batch cap fills) for riders, then commits the whole
batch through Volume.write_needles — ONE pwritev and at most ONE fsync
where N serial writes paid N of each. Results are byte-identical per
request by construction (write_needles runs the serial path's checks
and encodes at the serial path's offsets, in arrival order).

The C POST fast path declines to Python while a committer is active
(server/write_path.try_native_post is skipped) — the C hot loop's
one-call append can't ride a window, and batching is the bigger win
under the concurrency that makes windows fill.

`WEED_QOS=0` / `WEED_QOS_COMMIT=0` (or `-commitWindowUs 0`) restores
today's write-per-POST behavior wholesale; `-commitFsync` alone keeps
per-POST durability without batching (the A/B baseline the
fsyncs-per-POST bench ratio compares against).
"""

from __future__ import annotations

import threading

from seaweedfs_tpu_torch import qos
from seaweedfs_tpu_torch.stats.metrics import (
    GROUP_COMMIT_BATCHES,
    GROUP_COMMIT_WRITES,
)


class _Entry:
    __slots__ = ("needle", "stages", "done", "result")

    def __init__(self, needle, stages):
        self.needle = needle
        self.stages = stages
        self.done = threading.Event()
        self.result = None


class _Batch:
    __slots__ = ("entries", "nbytes", "full", "closed")

    def __init__(self):
        self.entries: list[_Entry] = []
        self.nbytes = 0
        self.full = threading.Event()
        self.closed = False


class GroupCommitter:
    def __init__(
        self,
        window_us: int = 500,
        max_bytes: int = 4 << 20,
        max_batch: int = 64,
        fsync: bool = False,
    ):
        self.window_us = window_us
        self.max_bytes = max_bytes
        self.max_batch = max_batch
        self.fsync = fsync
        self._lock = threading.Lock()
        self._open: dict[int, _Batch] = {}  # vid -> accepting batch

    # ------------------------------------------------------------------
    def active(self) -> bool:
        """Whether writes should route through the committer at all —
        also what makes the C POST fast path decline to Python."""
        return self.window_us > 0 and qos.enabled("commit")

    def depth(self) -> int:
        """Writes currently queued in open windows (the heartbeat's
        write_queue_depth field)."""
        with self._lock:
            return sum(len(b.entries) for b in self._open.values())

    # ------------------------------------------------------------------
    def write(self, volume, needle, stages: dict | None = None):
        """The write seam: returns (offset, size, unchanged) exactly
        like Volume.write_needle, raising the same exceptions."""
        if not self.active():
            res = volume.write_needle(needle, stages=stages)
            if self.fsync:
                volume.commit()
            return res
        entry = _Entry(needle, stages)
        with self._lock:
            batch = self._open.get(volume.id)
            leader = batch is None or batch.closed
            if leader:
                batch = _Batch()
                self._open[volume.id] = batch
            batch.entries.append(entry)
            batch.nbytes += len(needle.data or b"")
            if (
                len(batch.entries) >= self.max_batch
                or batch.nbytes >= self.max_bytes
            ):
                batch.full.set()
        if leader:
            self._commit(volume, batch)
        else:
            # the leader always signals every rider (even on error); the
            # long timeout is a belt against a leader thread dying to
            # something unhandled — surface loudly rather than hang
            if not entry.done.wait(timeout=60.0):
                raise RuntimeError(
                    f"group commit window for volume {volume.id} never "
                    "committed (leader died?)"
                )
        if isinstance(entry.result, BaseException):
            raise entry.result
        return entry.result

    def _commit(self, volume, batch: _Batch) -> None:
        batch.full.wait(self.window_us / 1e6)
        with self._lock:
            batch.closed = True
            if self._open.get(volume.id) is batch:
                del self._open[volume.id]
            entries = list(batch.entries)
        try:
            outcomes = volume.write_needles(
                [(e.needle, e.stages) for e in entries],
                durable=self.fsync,
            )
        except BaseException as e:  # noqa: BLE001 — fan the error out
            for en in entries:
                en.result = e
                en.done.set()
            raise
        GROUP_COMMIT_BATCHES.inc()
        GROUP_COMMIT_WRITES.inc(len(entries))
        for en, out in zip(entries, outcomes):
            en.result = out
            en.done.set()
