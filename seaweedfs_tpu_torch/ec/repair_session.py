"""Rebuild sessions: piggyback degraded serving onto in-progress repair
(the port of seaweedfs_tpu/ec/repair_session.py).

A rebuild of a lost shard decodes every byte of it from k survivors —
~k× the rebuilt bytes over the network (the Facebook warehouse study,
arXiv:1309.0186, measures exactly this k-gather as the #1 cluster
network tax). Meanwhile every *degraded GET* of the same volume is
independently gathering and decoding tiles of the very shard the
rebuild is regenerating, duplicating its reads byte for byte.

A RebuildSession joins the two planes on the rebuilding node:

  * the rebuild verb opens a session naming its target shards before
    the stream rebuild starts and closes it after;
  * degraded reads `donate()` every tile they reconstruct (and the
    session drains the volume's reconstructed-tile cache at open, so
    serving traffic that already ran counts too);
  * the rebuild's reader pool calls `consume()` per rebuild tile and
    fetches survivors only for the *gaps* donations don't cover —
    range-aligned sub-shard reads (arXiv:2205.11015's partial-repair
    observation: transfer only the bytes the decode actually needs);
  * `yield_to_serving()` between tiles keeps an active rebuild from
    starving live degraded GETs of the gather bandwidth they share —
    the serve-plane-first arbitration the RepairScheduler relies on
    (its repair verbs all run this rebuild).

Sessions are process-local: piggyback pays when degraded traffic lands
on the rebuilding node (common — the scheduler rebuilds on a surviving
holder, which serves reads for the shards it holds). Cross-node
donation would ship the tiles it saves; deliberately out of scope.
"""

from __future__ import annotations

import threading
import time

from seaweedfs_tpu_torch.stats.metrics import EC_REPAIR_DONATED_BYTES

_SESSIONS: dict[int, "RebuildSession"] = {}
_SESSIONS_LOCK = threading.Lock()

# donations kept at most this long per session before the cap drops new
# ones — a bound, not a budget: a shard is at most a few GB and serve
# tiles are 256 KiB, but a hot degraded workload could otherwise donate
# faster than the writer drains
_DONATION_CAP_BYTES = 64 << 20


class RebuildSession:
    def __init__(self, volume_id: int, targets: tuple[int, ...]):
        self.volume_id = volume_id
        self.targets = tuple(sorted(targets))
        self._lock = threading.Lock()
        # per-target shard: tile_off -> bytes (serve-tile granularity)
        self._donated: dict[int, dict[int, bytes]] = {
            t: {} for t in self.targets
        }
        self._bytes = 0
        # ranges the rebuild already claimed: late donations for them
        # are dropped (the decode already ran; bytes are identical)
        self._claimed: list[tuple[int, int]] = []
        self._serving = 0
        self._serving_cv = threading.Condition(self._lock)
        self.donated_bytes = 0  # accepted via donate()
        self.used_donated_bytes = 0  # actually consumed by the rebuild
        self.yields = 0  # times the reader pool paused for serving

    # -- serving side ------------------------------------------------------
    def donate(self, shard_id: int, offset: int, data: bytes) -> bool:
        """Hand a reconstructed tile to the rebuild. True when (some of)
        it was accepted: target shard, cap not exceeded, and at least
        part of the range still pending — a donation overlapping an
        already-claimed rebuild tile is TRIMMED to its unclaimed
        remainder, not rejected (serve tiles and rebuild tiles need not
        agree on size)."""
        if shard_id not in self._donated or not data:
            return False
        with self._lock:
            lo, hi = offset, offset + len(data)
            for c_off, c_len in self._claimed:
                if lo < c_off + c_len and c_off < hi:
                    if c_off <= lo and hi <= c_off + c_len:
                        return False  # fully claimed already
                    if c_off <= lo:
                        lo = c_off + c_len  # head claimed: keep tail
                    else:
                        hi = c_off  # tail (or middle) claimed: keep head
            if hi <= lo:
                return False
            data = data[lo - offset : hi - offset]
            offset = lo
            per = self._donated[shard_id]
            old = per.get(offset)
            if old is not None:
                return True  # already have these exact bytes
            if self._bytes + len(data) > _DONATION_CAP_BYTES:
                return False
            per[offset] = data
            self._bytes += len(data)
            self.donated_bytes += len(data)
            EC_REPAIR_DONATED_BYTES.inc(len(data))
            return True

    def serving_enter(self) -> None:
        with self._lock:
            self._serving += 1

    def serving_exit(self) -> None:
        with self._serving_cv:
            self._serving -= 1
            if self._serving <= 0:
                self._serving_cv.notify_all()

    # -- rebuild side -----------------------------------------------------
    def yield_to_serving(self, max_wait_s: float = 1.0) -> None:
        """Pause (bounded) while degraded gathers are in flight: repair
        is background work; a GET decoding right now owns the disks and
        the rack links first."""
        deadline = time.monotonic() + max_wait_s
        with self._serving_cv:
            waited = False
            while self._serving > 0:
                left = deadline - time.monotonic()
                if left <= 0:
                    break
                waited = True
                self._serving_cv.wait(min(left, 0.05))
            if waited:
                # one pause = one yield, however many wait slices it
                # took (per-slice counting inflated the stat ~20x)
                self.yields += 1

    def consume(
        self, offset: int, step: int
    ) -> tuple[list[tuple[int, dict[int, bytes]]], list[tuple[int, int]]]:
        """Split the rebuild tile [offset, offset+step) against the
        donations: returns (covered, gaps). `covered` entries are
        (sub_off, {target: bytes}) where EVERY target shard has donated
        bytes for the whole subrange; `gaps` are (sub_off, sub_len)
        ranges the rebuild must still gather survivors for. The claimed
        range rejects late donations; consumed donations are freed."""
        end = offset + step
        with self._lock:
            self._claimed.append((offset, step))
            # coverage = intersection across targets of donated ranges
            pieces: dict[int, dict[int, bytes]] = {}
            for t in self.targets:
                per = self._donated[t]
                for d_off in list(per):
                    data = per[d_off]
                    if d_off >= end or d_off + len(data) <= offset:
                        continue
                    # clip the donation to the tile
                    lo = max(d_off, offset)
                    hi = min(d_off + len(data), end)
                    pieces.setdefault(lo, {})
                    if pieces[lo].get(t) is None:
                        pieces[lo][t] = data[lo - d_off : hi - d_off]
                    # free the consumed span but KEEP the out-of-window
                    # remainders: a serve tile bigger than the rebuild
                    # tile would otherwise lose most of its bytes to
                    # the first claim and the gather would re-fetch
                    # ranges that were already donated
                    per.pop(d_off)
                    self._bytes -= len(data)
                    if d_off < offset:
                        head = data[: offset - d_off]
                        per[d_off] = head
                        self._bytes += len(head)
                    if d_off + len(data) > end:
                        tail = data[end - d_off :]
                        per[end] = tail
                        self._bytes += len(tail)
            covered: list[tuple[int, dict[int, bytes]]] = []
            for lo in sorted(pieces):
                per_t = pieces[lo]
                if len(per_t) != len(self.targets):
                    continue  # some target lacks this range: still a gap
                lens = {len(b) for b in per_t.values()}
                if len(lens) != 1:
                    # ragged donations: keep the common prefix
                    n = min(lens)
                    per_t = {t: b[:n] for t, b in per_t.items()}
                covered.append((lo, per_t))
        # merge overlaps defensively and compute the gaps
        covered.sort()
        pruned: list[tuple[int, dict[int, bytes]]] = []
        cursor = offset
        gaps: list[tuple[int, int]] = []
        for lo, per_t in covered:
            n = len(next(iter(per_t.values())))
            if lo < cursor:  # overlap with the previous piece: clip
                cut = cursor - lo
                if cut >= n:
                    continue
                per_t = {t: b[cut:] for t, b in per_t.items()}
                lo, n = cursor, n - cut
            if lo > cursor:
                gaps.append((cursor, lo - cursor))
            pruned.append((lo, per_t))
            cursor = lo + n
        if cursor < end:
            gaps.append((cursor, end - cursor))
        # charge AFTER pruning: clipped/dropped pieces must not inflate
        # the piggyback-savings number the rebuild bench reports
        used = sum(
            len(b) for _off, per_t in pruned for b in per_t.values()
        )
        if used:
            with self._lock:
                self.used_donated_bytes += used
        return pruned, gaps


def open_session(volume_id: int, targets) -> RebuildSession:
    sess = RebuildSession(volume_id, tuple(targets))
    with _SESSIONS_LOCK:
        _SESSIONS[volume_id] = sess
    return sess


def close_session(sess: RebuildSession) -> None:
    with _SESSIONS_LOCK:
        if _SESSIONS.get(sess.volume_id) is sess:
            _SESSIONS.pop(sess.volume_id, None)


def find(volume_id: int) -> RebuildSession | None:
    with _SESSIONS_LOCK:
        return _SESSIONS.get(volume_id)
