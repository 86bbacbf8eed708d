"""ScrubEngine: the volume server's background integrity sweeper.

Until this plane existed, integrity was purely reactive — a corrupt EC
shard was only noticed when a foreground read tripped over it
(EcVolume._quarantine_if_truncated), the quarantine never left the
process, and repair was a human typing `ec.rebuild`. The engine makes
detection continuous: every `interval` seconds it sweeps

  * plain volumes — every live needle re-read through the CRC32-C
    check (scrub/verify.scan_plain_volume);
  * EC volumes — all 14 shards streamed tile by tile through the
    parity re-verify (scrub/verify.verify_parity_stream), remote
    shards fetched from their holders via the same VolumeEcShardRead
    path degraded reads use; localized corrupt LOCAL shards are
    quarantined (unmount + .bad rename) on the spot.

Foreground p99 is protected by a token bucket charged before every
byte read, and by sweeping in bounded segments (the engine yields the
GIL and the bucket between segments). Cursors + health persist per
disk location (scrub/state.py) so restarts resume mid-volume. Every
corruption or quarantine fires `on_event` — the volume server wires
that to its heartbeat wake-up, so the master learns on the next forced
delta beat, not the next tick.

The port of seaweedfs_tpu/scrub/engine.py: an EC volume's sweep runs
through the volume's own codec (`ev.rs`), so a card server re-verifies
on the card, on its store's device. Its corruption counter's series are
created at 0 when the engine is, so the cluster collector's
scrub_corruptions alert sees a node's first corruption (the
reference's, born at the first corruption, shows it to no rule).
"""

from __future__ import annotations

import os
import threading
import time
from typing import Callable, Optional

from seaweedfs_tpu_torch import trace
from seaweedfs_tpu_torch.scrub import verify as _verify
from seaweedfs_tpu_torch.scrub.ratelimit import TokenBucket
from seaweedfs_tpu_torch.scrub.state import ScrubState, VolumeScrubHealth
from seaweedfs_tpu_torch.util import wlog

# per-shard bytes verified per EC segment / per plain segment before
# the engine persists cursors and re-checks stop/trigger; small enough
# that trigger() and stop() stay responsive at throttled rates
SEGMENT_BYTES = 64 * 1024 * 1024

STATE_FILE = "scrub_state.json"


class ScrubEngine:
    def __init__(
        self,
        store,
        *,
        interval: float = 600.0,
        rate_mb_s: float = 64.0,
        tile_bytes: int = _verify.DEFAULT_TILE_BYTES,
        fetcher_factory: Optional[Callable] = None,
        on_event: Optional[Callable[[], None]] = None,
        node_label: str = "",
    ):
        self.store = store
        self.interval = interval
        self.tile_bytes = tile_bytes
        # fetcher_factory(ev) -> fetch(sid, offset, size) -> bytes|None
        # (the volume server passes _remote_shard_fetcher so sweeps
        # reach shards this node doesn't hold)
        self.fetcher_factory = fetcher_factory
        self.on_event = on_event or (lambda: None)
        self.node_label = node_label
        # the corruption counter's series exist from the start, at 0: the
        # telemetry collector's increase() needs two samples of a series,
        # so one born at this node's first corruption (as the reference's
        # is) never shows that corruption to the scrub_corruptions alert
        from seaweedfs_tpu_torch.stats.metrics import SCRUB_CORRUPTIONS

        for kind in ("plain", "ec"):
            SCRUB_CORRUPTIONS.labels(node_label, kind).inc(0.0)
        # burst capped at 2 tiles (not the bucket's default of one
        # second of rate): a sweep start must trickle, not storm — a
        # 64 MB burst of back-to-back preads+CRC is a foreground p99
        # spike regardless of the steady-state rate
        self.limiter = TokenBucket(
            rate_mb_s * 1024 * 1024,
            burst_bytes=2 * tile_bytes if rate_mb_s > 0 else None,
        )
        self.rate_mb_s = rate_mb_s
        self._states: dict[str, ScrubState] = {}
        for loc in store.locations:
            self._states[loc.directory] = ScrubState(
                os.path.join(loc.directory, STATE_FILE)
            )
        self._stop = threading.Event()
        self._wake = threading.Event()
        self._priority: list[int] = []  # vids queued by trigger()
        self._lock = threading.Lock()
        self._thread: threading.Thread | None = None
        self.sweeps_completed = 0
        self.sweep_running = False
        self.last_sweep_started = 0.0
        self.last_sweep_finished = 0.0

    # ------------------------------------------------------------------
    def start(self) -> None:
        # check+spawn under one hold: two concurrent start() calls must
        # not both see None and double-spawn the loop (weedlint v4
        # race-check-then-act)
        with self._lock:
            if self._thread is not None:
                return
            self._thread = threading.Thread(
                target=self._loop, daemon=True, name="scrub-engine"
            )
            self._thread.start()

    def stop(self) -> None:
        self._stop.set()
        self._wake.set()
        if self._thread is not None:
            self._thread.join(timeout=10)

    def trigger(self, vid: int | None = None) -> None:
        """Start a sweep now; with `vid`, scrub that volume first."""
        if vid is not None:
            with self._lock:
                if vid not in self._priority:
                    self._priority.append(vid)
        self._wake.set()

    def _loop(self) -> None:
        # first sweep only after one full interval: a restart storm
        # must not synchronize every node into sweeping at boot
        while not self._stop.is_set():
            self._wake.wait(self.interval)
            self._wake.clear()
            if self._stop.is_set():
                return
            try:
                self.sweep_once()
            except Exception:  # noqa: BLE001 - the sweeper must survive
                import traceback

                # NOTE: wlog.warning has no exc_info kwarg — passing it
                # raises TypeError and KILLS this thread silently (the
                # engine then never sweeps again); format explicitly
                wlog.warning(
                    "scrub: sweep crashed: %s", traceback.format_exc()
                )

    # ------------------------------------------------------------------
    def sweep_once(self) -> dict:
        """One full pass over every local volume (resuming cursors).
        Returns a summary dict (also used by tests and /scrub/trigger)."""
        self.sweep_running = True
        self.last_sweep_started = time.time()
        summary = {"volumes": 0, "ec_volumes": 0, "corruptions": 0,
                   "quarantined": 0, "scanned_bytes": 0}
        try:
            with self._lock:
                priority = list(self._priority)
                self._priority.clear()

            def order(vids):
                return sorted(vids, key=lambda v: (v not in priority, v))

            for loc in self.store.locations:
                state = self._states[loc.directory]
                for vid in order(list(loc.volumes)):
                    if self._stop.is_set():
                        return summary
                    v = loc.volumes.get(vid)
                    if v is None:
                        continue
                    try:
                        # tracing plane: each volume's scrub is a span
                        # tagged plane=scrub, so any remote reads it
                        # triggers are visibly NOT serving traffic
                        with trace.span(
                            "scrub.volume", plane="scrub",
                            node=self.node_label,
                        ) as sp:
                            if sp:
                                sp.annotate("vid", vid)
                            r = self._scrub_plain(v, state)
                    except Exception as e:  # noqa: BLE001
                        # one un-scrubable volume (deleted/compacted
                        # under us mid-sweep) must not abort the pass
                        # for every volume after it
                        wlog.warning(
                            "scrub: volume %d sweep failed: %r", vid, e
                        )
                        continue
                    summary["volumes"] += 1
                    summary["corruptions"] += r[0]
                    summary["scanned_bytes"] += r[1]
                for vid in order(list(loc.ec_volumes)):
                    if self._stop.is_set():
                        return summary
                    ev = loc.ec_volumes.get(vid)
                    if ev is None:
                        continue
                    try:
                        with trace.span(
                            "scrub.ec_volume", plane="scrub",
                            node=self.node_label,
                        ) as sp:
                            if sp:
                                sp.annotate("vid", vid)
                            c, q, b = self._scrub_ec(ev, state)
                    except Exception as e:  # noqa: BLE001
                        wlog.warning(
                            "scrub: ec volume %d sweep failed: %r", vid, e
                        )
                        continue
                    summary["ec_volumes"] += 1
                    summary["corruptions"] += c
                    summary["quarantined"] += q
                    summary["scanned_bytes"] += b
                # prune rows for volumes that left this location
                # (deleted, EC-migrated, moved): their stale health
                # must not keep riding heartbeats. list() snapshots —
                # foreground allocate/delete mutates these dicts from
                # HTTP handler threads mid-iteration
                present = {(vid, False) for vid in list(loc.volumes)} | {
                    (vid, True) for vid in list(loc.ec_volumes)
                }
                for key in list(state.volumes):
                    if key not in present:
                        state.forget(*key)
                state.save()
            self.sweeps_completed += 1
            self.last_sweep_finished = time.time()
        finally:
            self.sweep_running = False
        return summary

    # ------------------------------------------------------------------
    def _scrub_plain(self, v, state: ScrubState) -> tuple[int, int]:
        from seaweedfs_tpu_torch.stats.metrics import (
            SCRUB_CORRUPTIONS,
            SCRUB_SCANNED,
        )

        h = state.get(v.id, is_ec=False)
        found = scanned = 0
        if h.cursor == 0:
            h.pass_corruptions = 0  # fresh pass starts its own count
        # ONE needle-map enumeration per volume pass, sliced across
        # segments via `consumed` — re-sorting millions of keys every
        # 64 MiB segment would be O(segments x needles) of GIL time
        # the token bucket never accounts for
        keys = _verify.live_needle_keys(v, h.cursor)
        while not self._stop.is_set():
            res = _verify.scan_plain_volume(
                v,
                after_key=h.cursor,
                keys=keys,
                limiter=self.limiter,
                stop=self._stop,
                max_bytes=SEGMENT_BYTES,
            )
            keys = keys[res.consumed :]
            h.cursor = res.last_key
            h.scanned_bytes += res.scanned_bytes
            scanned += res.scanned_bytes
            SCRUB_SCANNED.labels(self.node_label, "plain").inc(
                res.scanned_bytes
            )
            if res.corruptions:
                found += len(res.corruptions)
                h.corruptions_found += len(res.corruptions)
                h.pass_corruptions += len(res.corruptions)
                # report new damage NOW (never zeroed mid-pass: a
                # still-corrupt volume must not read clean to the
                # scheduler, or its backoff state would reset each sweep)
                h.sweep_corruptions = max(
                    h.sweep_corruptions, h.pass_corruptions
                )
                h.last_error = (
                    f"needle {res.corruptions[-1][0]}: "
                    f"{res.corruptions[-1][1]}"
                )
                SCRUB_CORRUPTIONS.labels(self.node_label, "plain").inc(
                    len(res.corruptions)
                )
                wlog.warning(
                    "scrub: volume %d: %d corrupt needle(s), e.g. %s",
                    v.id, len(res.corruptions), h.last_error,
                )
                self.on_event()
            state.save()
            if res.aborted:
                break
            if res.complete:
                h.cursor = 0
                h.sweeps += 1
                h.last_sweep_unix = time.time()
                # a COMPLETED pass is the new truth: drops to 0 after
                # a repair, stays honest for persistent damage
                h.sweep_corruptions = h.pass_corruptions
                if h.sweep_corruptions == 0:
                    h.last_error = ""  # clean pass supersedes history
                state.save()
                break
        return found, scanned

    # ------------------------------------------------------------------
    def _ec_readers(self, ev):
        """14 shard readers: local pread where mounted, remote
        VolumeEcShardRead (via the server's fetcher) otherwise.
        Returns None when some shard is reachable nowhere."""
        from seaweedfs_tpu_torch.ec.ec_volume import ShardTruncated

        fetch = self.fetcher_factory(ev) if self.fetcher_factory else None
        readers = []
        for sid in range(ev.rs.total_shards):
            shard = ev.shards.get(sid)
            if shard is not None:
                def read_local(off, size, _s=shard, _sid=sid):
                    # clamp like VolumeEcShardRead: a walk off the end
                    # of the shard is EOF, not truncation
                    n = min(size, max(0, _s.size - off))
                    if n <= 0:
                        return b""
                    try:
                        return _s.read_at(off, n)
                    except ShardTruncated:
                        # the sweep found a shard shorter on disk than
                        # its nominal length: same quarantine a
                        # foreground read would perform
                        ev._quarantine_if_truncated(_sid)
                        raise

                readers.append(read_local)
            elif fetch is not None:
                def read_remote(off, size, _sid=sid, _f=fetch):
                    data = _f(_sid, off, size)
                    if data is None:
                        raise RuntimeError(
                            f"ec shard {_sid} reachable nowhere"
                        )
                    return data

                readers.append(read_remote)
            else:
                return None
        return readers

    def _scrub_ec(self, ev, state: ScrubState) -> tuple[int, int, int]:
        from seaweedfs_tpu_torch.stats.metrics import (
            SCRUB_CORRUPTIONS,
            SCRUB_SCANNED,
        )

        h = state.get(ev.volume_id, is_ec=True)
        # `.ecc` fast path: a fresh sidecar turns the 14-shard parity
        # re-verify into a read+CRC pass (scrub/verify.verify_ecc_stream).
        # Eligibility is checked every volume visit; missing/stale
        # sidecars fall through LOUDLY (wlog + fallback counter) — the
        # parity sweep below still verifies everything.
        ecc = self._scrub_ec_ecc(ev, state, h)
        if ecc is not None:
            return ecc
        found = quarantined = scanned = 0
        if h.cursor == 0:
            h.pass_corruptions = 0
        while not self._stop.is_set():
            readers = self._ec_readers(ev)
            if readers is None:
                h.last_error = "shards missing and no remote fetcher"
                state.save()
                break
            # snapshot so the error handler can see quarantines that
            # happened DURING the verify (read_local self-quarantines a
            # truncated shard before re-raising)
            quarantined_before = set(ev.quarantined)
            try:
                res = _verify.verify_parity_stream(
                    readers,
                    rs=ev.rs,
                    start=h.cursor,
                    tile_bytes=self.tile_bytes,
                    limiter=self.limiter,
                    stop=self._stop,
                    max_bytes=SEGMENT_BYTES,
                )
            except (RuntimeError, OSError) as e:
                # length skew or an unreachable remote shard. Skew can
                # be transient (a shard being rebuilt under us) — but a
                # shard that was truncated BEFORE mount has a stale
                # short .size that the local reader clamps to, so the
                # skew is permanent and would stall this volume's scrub
                # forever. Re-verify every local shard's on-disk length
                # against the siblings' nominal; genuinely short ones
                # get the same quarantine a foreground read performs,
                # and the sweep retries immediately via remote fetch.
                evicted = sum(
                    1
                    for sid in list(ev.shards)
                    if ev._quarantine_if_truncated(sid)
                )
                # read_local may have quarantined the culprit itself
                # mid-verify (ShardTruncated path) — that eviction also
                # makes an immediate remote-fetch retry viable
                evicted += len(set(ev.quarantined) - quarantined_before)
                if evicted:
                    quarantined += evicted
                    self.on_event()
                    continue
                h.last_error = str(e)
                state.save()
                break
            h.cursor = res.end_offset
            h.scanned_bytes += res.bytes_per_shard * ev.rs.total_shards
            scanned += res.bytes_per_shard * ev.rs.total_shards
            SCRUB_SCANNED.labels(self.node_label, "ec").inc(
                res.bytes_per_shard * ev.rs.total_shards
            )
            if res.corrupt:
                found += len(res.bad_tiles)
                h.corruptions_found += len(res.bad_tiles)
                h.pass_corruptions += len(res.bad_tiles)
                h.sweep_corruptions = max(
                    h.sweep_corruptions, h.pass_corruptions
                )
                SCRUB_CORRUPTIONS.labels(self.node_label, "ec").inc(
                    len(res.bad_tiles)
                )
                h.last_error = (
                    f"parity mismatch {res.mismatch}; culprits "
                    f"{sorted(res.culprits)}; unlocalized {res.unlocalized}"
                )
                for sid in sorted(res.culprits):
                    if sid in ev.shards:
                        wlog.warning(
                            "scrub: quarantining corrupt shard %d of "
                            "vid %d (%d bad tile(s))",
                            sid, ev.volume_id, res.culprits[sid],
                        )
                        if ev.quarantine_shard(
                            sid, f"scrub: {res.culprits[sid]} corrupt tile(s)"
                        ):
                            quarantined += 1
                    else:
                        wlog.warning(
                            "scrub: vid %d shard %d corrupt on a REMOTE "
                            "holder; reporting via heartbeat",
                            ev.volume_id, sid,
                        )
                self.on_event()
            state.save()
            if res.aborted:
                break
            if res.complete:
                h.cursor = 0
                h.sweeps += 1
                h.last_sweep_unix = time.time()
                h.sweep_corruptions = h.pass_corruptions
                if h.sweep_corruptions == 0:
                    h.last_error = ""
                    # a clean FULL pass proves the cluster-wide volume
                    # is healthy again (the pass read the quarantined
                    # shards' rebuilt replacements, wherever they
                    # live): local quarantine markers are now history,
                    # not current damage — clearing stops the master
                    # re-flagging a repaired volume forever
                    for sid in list(ev.quarantined):
                        ev.quarantined.pop(sid, None)
                        self.store.clear_quarantine(ev.volume_id, sid)
                state.save()
                break
        return found, quarantined, scanned

    # ------------------------------------------------------------------
    def _scrub_ec_ecc(self, ev, state: ScrubState, h) -> tuple[int, int, int] | None:
        """The `.ecc` sidecar arm of the EC sweep; None = not eligible
        (knob off, shards not all local, sidecar missing/stale) — the
        caller then runs the full parity re-verify.

        Eligibility requires every shard LOCAL: the sidecar lives next
        to the shards it attests, and a CRC pass over remote shards
        would just move the same bytes over the network that the parity
        path moves (each holder scrubs its own copy instead)."""
        from seaweedfs_tpu_torch.ec import ecc_sidecar
        from seaweedfs_tpu_torch.stats.metrics import (
            SCRUB_CORRUPTIONS,
            SCRUB_ECC_FALLBACK,
            SCRUB_SCANNED,
        )

        if not ecc_sidecar.ecc_enabled():
            return None
        local = {sid: s.path for sid, s in ev.shards.items()}
        if len(local) != ev.rs.total_shards:
            return None  # remote shards: parity path, no fallback noise
        status, doc = ecc_sidecar.sidecar_status(
            ev.base_name, local, ev.rs.total_shards
        )
        if status != "ok":
            wlog.warning(
                "scrub: vid %d .ecc sidecar %s; falling back to full "
                "parity re-verify",
                ev.volume_id, status,
            )
            SCRUB_ECC_FALLBACK.labels(self.node_label, status).inc()
            return None
        found = quarantined = scanned = 0
        if h.ecc_shard == 0 and h.ecc_offset == 0:
            h.pass_corruptions = 0
        while not self._stop.is_set():
            res = _verify.verify_ecc_stream(
                local,
                doc,
                start_shard=h.ecc_shard,
                start_offset=h.ecc_offset,
                run_crc=h.ecc_crc,
                tile_bytes=self.tile_bytes,
                limiter=self.limiter,
                stop=self._stop,
                max_bytes=SEGMENT_BYTES,
            )
            h.ecc_shard = res.shard_idx
            h.ecc_offset = res.offset
            h.ecc_crc = res.run_crc
            h.scanned_bytes += res.bytes_scanned
            scanned += res.bytes_scanned
            SCRUB_SCANNED.labels(self.node_label, "ec").inc(res.bytes_scanned)
            if res.corrupt:
                found += len(res.bad_shards)
                h.corruptions_found += len(res.bad_shards)
                h.pass_corruptions += len(res.bad_shards)
                h.sweep_corruptions = max(
                    h.sweep_corruptions, h.pass_corruptions
                )
                SCRUB_CORRUPTIONS.labels(self.node_label, "ec").inc(
                    len(res.bad_shards)
                )
                worst = sorted(res.bad_shards)[-1]
                h.last_error = (
                    f".ecc mismatch shard {worst}: {res.bad_shards[worst]}"
                )
                # the sidecar pins the culprit directly (a CRC names
                # its shard) — no localization pass needed
                for sid, why in sorted(res.bad_shards.items()):
                    if sid in ev.shards:
                        wlog.warning(
                            "scrub: quarantining shard %d of vid %d "
                            "(.ecc: %s)", sid, ev.volume_id, why,
                        )
                        if ev.quarantine_shard(sid, f"scrub .ecc: {why}"):
                            quarantined += 1
                self.on_event()
            state.save()
            if res.aborted:
                break
            if res.complete:
                h.ecc_shard = h.ecc_offset = h.ecc_crc = 0
                h.sweeps += 1
                h.last_sweep_unix = time.time()
                h.sweep_corruptions = h.pass_corruptions
                if h.sweep_corruptions == 0:
                    h.last_error = ""
                    for sid in list(ev.quarantined):
                        ev.quarantined.pop(sid, None)
                        self.store.clear_quarantine(ev.volume_id, sid)
                state.save()
                break
        return found, quarantined, scanned

    # ------------------------------------------------------------------
    def health_rows(self) -> list[VolumeScrubHealth]:
        rows: list[VolumeScrubHealth] = []
        for state in self._states.values():
            with state._lock:
                rows.extend(list(state.volumes.values()))
        return rows

    def status(self) -> dict:
        return {
            "Interval": self.interval,
            "RateMBs": self.rate_mb_s,
            "SweepRunning": self.sweep_running,
            "SweepsCompleted": self.sweeps_completed,
            "LastSweepStarted": self.last_sweep_started,
            "LastSweepFinished": self.last_sweep_finished,
            "Volumes": [h.to_dict() for h in self.health_rows()],
        }
