"""TierScheduler: the master's lifecycle-tiering loop.

Leader-only, like the RepairScheduler it is modeled on: every
`interval` it scans the EC shard registry, asks each holder for its
local tier state (/tier/status — shard mtimes give the age signal),
reads the volume's access temperature out of the telemetry rings
(`weed_volume_read_total`), and drives /tier/move POSTs at holders
whose shards the rules classify cold (out) or hot again (in).

Each holder tiers its OWN shards — the move verb streams that node's
local shard files to the backend through the bandwidth arbiter's
"tier" claimant, so a scan that surfaces many cold volumes cannot
stampede the cluster: the arbiter paces every holder independently
and yields to foreground serving.

Every move hop carries X-Weed-Deadline (one whole-move budget — a
wedged backend costs a bounded failed attempt, not a parked slot) and
X-Weed-Trace (plane=tier, so tier traffic competing with serving is
attributable in trace dumps).

The port of seaweedfs_tpu/tier/scheduler.py. The port's master has no
telemetry collector yet (ROADMAP item 13), so every volume reads cold
and age alone gates tiering, as on a reference master with the
collector off. stop() also joins the moves the scheduler launched.
"""

from __future__ import annotations

import threading
import time
import urllib.request
from collections import deque

from seaweedfs_tpu_torch import trace
from seaweedfs_tpu_torch.tier.rules import TierRules, tier_enabled
from seaweedfs_tpu_torch.util import deadline as _deadline
from seaweedfs_tpu_torch.util import wlog


class TierScheduler:
    def __init__(
        self,
        master,
        interval: float = 60.0,
        rules: TierRules | None = None,
        concurrency: int = 2,
        move_deadline_s: float = 600.0,
        cooldown_s: float = 120.0,
        temperature_window_s: float = 120.0,
    ):
        self.master = master
        self.interval = interval
        # None = re-read the env-backed rules every scan (operators
        # retune without a restart; tests inject a fixed TierRules)
        self.rules = rules
        self.concurrency = concurrency
        self.move_deadline_s = move_deadline_s
        self.cooldown_s = cooldown_s
        self.temperature_window_s = temperature_window_s
        self._stop = threading.Event()
        self._wake = threading.Event()
        self._lock = threading.Lock()
        self._thread: threading.Thread | None = None
        self._workers: list[threading.Thread] = []  # launched moves
        self._active = 0
        # (holder, vid) → unix time before which no new move launches
        self._cooling: dict[tuple[str, int], float] = {}
        self.history: deque = deque(maxlen=50)
        self.moves_started = 0
        self.moves_failed = 0
        self.last_scan_unix = 0.0

    # ------------------------------------------------------------------
    def start(self) -> None:
        # check+spawn under one hold: two concurrent start() calls must
        # not both see None and double-spawn the loop (weedlint v4
        # race-check-then-act)
        with self._lock:
            if self._thread is not None:
                return
            self._thread = threading.Thread(
                target=self._loop, daemon=True, name="tier-scheduler"
            )
            self._thread.start()

    def stop(self) -> None:
        self._stop.set()
        self._wake.set()
        if self._thread is not None:
            self._thread.join(timeout=10)
        with self._lock:
            workers = list(self._workers)
        for t in workers:
            t.join(timeout=60)

    def trigger(self) -> None:
        self._wake.set()

    def _loop(self) -> None:
        while not self._stop.is_set():
            self._wake.wait(self.interval)
            self._wake.clear()
            if self._stop.is_set():
                return
            if not getattr(self.master, "is_leader", True):
                continue
            try:
                self.scan_once()
            except Exception:  # noqa: BLE001 — the scheduler must survive
                import traceback

                wlog.warning(
                    "tier: scan crashed: %s", traceback.format_exc()
                )

    # ------------------------------------------------------------------
    # signals
    def read_rate(self, vid: int) -> float:
        """Telemetry-observed reads/s for this volume, summed across
        every scraped node; 0.0 (cold) with the collector off."""
        tel = getattr(self.master, "telemetry", None)
        if tel is None:
            return 0.0
        now = time.time()
        want = str(vid)
        with tel._targets_lock:
            targets = list(tel.targets.values())
        total = 0.0
        for ts in targets:
            total += ts.rate_sum(
                "weed_volume_read_total",
                self.temperature_window_s,
                now,
                label_filter=lambda l: l.get("volume") == want,
            )
        return total

    def _holder_urls(self, vid: int) -> list[str]:
        urls: set[str] = set()
        locs = self.master.topology.ec_shard_map.get(vid)
        if locs is None:
            return []
        for holders in locs.locations:
            for dn in holders:
                urls.add(dn.url)
        return sorted(urls)

    # ------------------------------------------------------------------
    def _http_json(self, method: str, url: str, timeout: float) -> dict:
        import json as _json

        req = urllib.request.Request(
            url, method=method, data=b"" if method == "POST" else None
        )
        # deadline plane: the whole move runs under one budget the
        # holder inherits (its backend IO derives timeouts from it)
        dl = _deadline.current()
        if dl is not None:
            req.add_header(_deadline.DEADLINE_HEADER, dl.header_value())
        tv = trace.header_value()
        if tv:
            req.add_header("X-Weed-Trace", tv)
        with urllib.request.urlopen(req, timeout=timeout) as r:
            return _json.loads(r.read())

    def _run_move(self, holder: str, vid: int, direction: str, backend: str) -> None:
        t0 = time.time()
        err = ""
        try:
            with trace.span(f"tier.{direction}", plane="tier") as sp, \
                    _deadline.scope(
                        _deadline.Deadline.after(self.move_deadline_s)
                    ):
                if sp:
                    sp.annotate("vid", vid)
                qs = f"volumeId={vid}&direction={direction}"
                if direction == "out":
                    qs += f"&destination={backend}"
                self._http_json(
                    "POST",
                    f"http://{holder}/tier/move?{qs}",
                    timeout=self.move_deadline_s,
                )
        except Exception as e:  # noqa: BLE001 — recorded, retried next scan
            err = str(e)[:300]
            with self._lock:
                self.moves_failed += 1
            wlog.warning(
                "tier: %s vid %d @ %s failed: %s", direction, vid, holder, e
            )
        with self._lock:
            self._active -= 1
            self._cooling[(holder, vid)] = time.time() + self.cooldown_s
            self.history.append(
                {
                    "VolumeId": vid,
                    "Holder": holder,
                    "Direction": direction,
                    "FinishedUnix": round(time.time(), 3),
                    "Seconds": round(time.time() - t0, 3),
                    "Error": err,
                }
            )

    # ------------------------------------------------------------------
    def scan_once(self) -> int:
        """One scan over the EC registry; returns moves launched. Also
        the synchronous seam tests drive."""
        self.last_scan_unix = time.time()
        if not tier_enabled():
            return 0
        rules = self.rules or TierRules.from_env()
        if not rules.backend:
            return 0
        now = time.time()
        launched = 0
        status_cache: dict[str, dict] = {}
        for vid in list(self.master.topology.ec_shard_map):
            rate = self.read_rate(vid)
            for holder in self._holder_urls(vid):
                with self._lock:
                    if self._active + launched >= self.concurrency:
                        return launched
                    if now < self._cooling.get((holder, vid), 0.0):
                        continue
                st = status_cache.get(holder)
                if st is None:
                    try:
                        st = self._http_json(
                            "GET", f"http://{holder}/tier/status", timeout=10
                        )
                    except OSError as e:
                        wlog.info("tier: %s unreachable: %s", holder, e)
                        st = {}
                    status_cache[holder] = st
                row = st.get(str(vid))
                if row is None:
                    continue
                tiered = bool(row.get("Tiered"))
                mtime = float(row.get("NewestShardMtime") or 0.0)
                age = (now - mtime) if mtime > 0 else float("inf")
                direction = rules.decide(age, rate, tiered)
                if direction is None:
                    continue
                with self._lock:
                    # re-validate the cap inside the hold that takes
                    # the slot: the earlier check released the lock
                    # across the /tier/status fetch, and a concurrent
                    # scan (admin-triggered scan_once next to the loop)
                    # could have filled the budget in between
                    if self._active >= self.concurrency:
                        return launched
                    self._active += 1
                    self.moves_started += 1
                launched += 1
                t = threading.Thread(
                    target=self._run_move,
                    args=(holder, vid, direction, rules.backend),
                    daemon=True,
                    name=f"tier-{direction}-{vid}",
                )
                with self._lock:
                    self._workers = [w for w in self._workers if w.is_alive()]
                    self._workers.append(t)
                t.start()
        return launched

    # ------------------------------------------------------------------
    def status_snapshot(self) -> dict:
        rules = self.rules or TierRules.from_env()
        with self._lock:
            return {
                "Enabled": tier_enabled(),
                "Rules": rules.to_dict(),
                "IntervalSeconds": self.interval,
                "Active": self._active,
                "MovesStarted": self.moves_started,
                "MovesFailed": self.moves_failed,
                "LastScanUnix": round(self.last_scan_unix, 3),
                "History": list(self.history),
            }
