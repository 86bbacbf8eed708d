"""Incident capsules (weedscope, docs/TELEMETRY.md).

When an alert transitions to firing — or an operator runs
`capsule.capture` — the node snapshots its volatile evidence into a
durably-published capsule directory: the blackbox flight-recorder ring
(trace/blackbox.py), the completed-span ring (/debug/traces), the
sampling profiler's folded stacks, the current /metrics exposition,
and — on the leader — the relevant TSDB window plus the alert/SLO/
health verdicts. Minutes later, after rings have wrapped and gauges
have moved on, the capsule is still exactly what the node knew at the
moment the objective burned.

Publication rides util/durable.publish (fsync bytes → rename → fsync
dir) file by file, with MANIFEST.json published LAST: a capsule is
valid if and only if its manifest exists, so a crash mid-capture
leaves a garbage-collectable partial, never a plausible-looking lie.

Process-global by design: providers register once per daemon process;
the per-node HTTP surface (`/capsule/capture`, `/capsule/list`,
`/capsule/get`) is served by the mini-loop funnel on EVERY daemon, and
the leader-side `capsule.collect` shell verb merges per-node capsules
by trace id into one cross-node incident view.

Knobs: `WEED_CAPSULE_DIR` (default <tmp>/weed-capsules),
`WEED_CAPSULE_KEEP` retained capsules (default 8),
`WEED_CAPSULE_COOLDOWN_S` per-(alert,target) auto-capture damping
(default 60). `WEED_SCOPE=0` disables auto-capture with the rest of
the weedscope plane; manual capture keeps working (an operator asking
for evidence should always get it).

The port of seaweedfs_tpu/telemetry/capsule.py, over the port's blackbox
(trace/blackbox.py), span ring, sampling profiler and metrics registry.
A CaptureCoordinator keeps the capture threads it starts, and join()
waits for them: the master's stop() calls it through the collector.
"""

from __future__ import annotations

import itertools
import json
import os
import re
import shutil
import tempfile
import threading
import time
import urllib.parse
import urllib.request

from seaweedfs_tpu_torch.stats.metrics import CAPSULE_CAPTURES
from seaweedfs_tpu_torch.util import wlog
from seaweedfs_tpu_torch.util.durable import fsync_dir, publish

_KEEP = max(1, int(os.environ.get("WEED_CAPSULE_KEEP", "8") or 8))
_COOLDOWN_S = float(os.environ.get("WEED_CAPSULE_COOLDOWN_S", "60") or 60)

_lock = threading.Lock()
_dir_override: str | None = None
_seq = itertools.count()
_last_capture: dict[str, float] = {}  # cooldown key -> unix time

# name -> (fn, kind); kind "json" (fn returns a JSON-able object) or
# "text" (fn returns str). Ordered: the manifest lists files in
# registration order.
_providers: dict[str, tuple] = {}

_SLUG_RE = re.compile(r"[^a-zA-Z0-9_.-]+")
_ID_RE = re.compile(r"^[0-9]{10,}-[0-9]+-[a-zA-Z0-9_.-]+$")


def capsule_dir() -> str:
    with _lock:
        if _dir_override:
            return _dir_override
    return os.environ.get("WEED_CAPSULE_DIR", "") or os.path.join(
        tempfile.gettempdir(), "weed-capsules"
    )


def set_dir(path: str) -> None:
    """Daemon/test override for the capsule directory (a volume server
    colocating capsules with its data disks, a bench isolating runs)."""
    global _dir_override
    with _lock:
        _dir_override = path or None


def add_provider(name: str, fn, kind: str = "json") -> None:
    """Register a capsule section. `fn()` is called at capture time and
    must be exception-safe-ish — a raising provider is recorded in the
    manifest as failed, never aborts the capsule (partial evidence
    beats none)."""
    with _lock:
        _providers[name] = (fn, kind)


def _default_providers() -> None:
    """The sections every daemon gets. Imports are deferred to capture
    time so merely importing this module costs nothing."""

    def blackbox():
        from seaweedfs_tpu_torch.trace import blackbox as bb

        return bb.snapshot(512)

    def traces():
        from seaweedfs_tpu_torch.trace import tracer

        return tracer.debug_payload(256)

    def profile():
        from seaweedfs_tpu_torch.telemetry import profiler

        # seconds=0: the instant since-start aggregate — capture must
        # not park the alert path for a sampling window
        return profiler.render_folded(profiler.capture(0.0))

    def metrics():
        from seaweedfs_tpu_torch.stats.metrics import DEFAULT_REGISTRY

        return DEFAULT_REGISTRY.render_text()

    add_provider("blackbox", blackbox, "json")
    add_provider("traces", traces, "json")
    add_provider("profile", profile, "text")
    add_provider("metrics", metrics, "text")


_default_providers()


def _publish_bytes(cap_dir: str, name: str, data: bytes) -> None:
    tmp = os.path.join(cap_dir, f".{name}.tmp")
    with open(tmp, "wb") as f:
        f.write(data)
    publish(tmp, os.path.join(cap_dir, name))


def capture(
    reason: str, trigger: str = "manual", node: str = "", root: str | None = None
) -> dict:
    """Snapshot every provider into a new capsule directory; returns
    the manifest (id, node, files, per-provider status)."""
    now = time.time()
    slug = _SLUG_RE.sub("-", reason or "manual")[:80].strip("-.") or "manual"
    cap_id = f"{int(now * 1000):013d}-{next(_seq)}-{slug}"
    base = root or capsule_dir()
    cap_dir = os.path.join(base, cap_id)
    os.makedirs(cap_dir, exist_ok=True)
    with _lock:
        providers = dict(_providers)
    files: list[dict] = []
    for name, (fn, kind) in providers.items():
        fname = name + (".json" if kind == "json" else ".txt")
        try:
            payload = fn()
            data = (
                json.dumps(payload).encode()
                if kind == "json"
                else str(payload).encode()
            )
            _publish_bytes(cap_dir, fname, data)
            files.append({"Name": fname, "Bytes": len(data), "Ok": True})
        except Exception as e:  # noqa: BLE001 — partial evidence > none
            files.append({"Name": fname, "Ok": False, "Error": str(e)[:300]})
    manifest = {
        "Id": cap_id,
        "Reason": reason,
        "Trigger": trigger,
        "Node": node,
        "CapturedAtUnix": round(now, 3),
        "Files": files,
    }
    # the manifest goes LAST: its presence is the capsule's validity
    _publish_bytes(cap_dir, "MANIFEST.json", json.dumps(manifest).encode())
    fsync_dir(base)
    CAPSULE_CAPTURES.labels(trigger).inc()
    wlog.info("capsule captured %s (%s) -> %s", cap_id, reason, cap_dir)
    _prune(base)
    return manifest


def _prune(base: str) -> None:
    """Bounded retention: keep the newest WEED_CAPSULE_KEEP valid
    capsules; manifest-less partials older than an hour are crash
    leftovers and go too."""
    try:
        entries = sorted(os.listdir(base))
    except OSError:
        return
    valid = [
        e for e in entries
        if _ID_RE.match(e)
        and os.path.exists(os.path.join(base, e, "MANIFEST.json"))
    ]
    doomed = valid[:-_KEEP] if len(valid) > _KEEP else []
    cutoff = time.time() - 3600.0
    for e in entries:
        if not _ID_RE.match(e) or e in valid:
            continue
        try:
            if os.path.getmtime(os.path.join(base, e)) < cutoff:
                doomed.append(e)
        except OSError:
            continue
    for e in doomed:
        shutil.rmtree(os.path.join(base, e), ignore_errors=True)


def list_capsules(root: str | None = None) -> list[dict]:
    """Manifests of every valid capsule, oldest first."""
    base = root or capsule_dir()
    out: list[dict] = []
    try:
        entries = sorted(os.listdir(base))
    except OSError:
        return out
    for e in entries:
        if not _ID_RE.match(e):
            continue
        try:
            with open(os.path.join(base, e, "MANIFEST.json"), "rb") as f:
                out.append(json.loads(f.read()))
        except (OSError, ValueError):
            continue
    return out


def read_file(cap_id: str, name: str, root: str | None = None) -> bytes | None:
    """One capsule file's bytes, with the id/name validated against
    the capsule naming scheme (this backs an HTTP endpoint — no path
    traversal)."""
    if not _ID_RE.match(cap_id) or "/" in name or name.startswith("."):
        return None
    try:
        with open(os.path.join(root or capsule_dir(), cap_id, name), "rb") as f:
            return f.read()
    except OSError:
        return None


# ---------------------------------------------------------------------------
# alert-triggered capture


def should_autocapture(key: str, now: float | None = None) -> bool:
    """Per-(alert,target) cooldown gate so one flapping rule cannot
    churn the capsule directory through its retention bound."""
    now = time.time() if now is None else now
    with _lock:
        if now - _last_capture.get(key, 0.0) < _COOLDOWN_S:
            return False
        _last_capture[key] = now
        return True


class CaptureCoordinator:
    """The AlertManager on_fire hook: captures a local capsule and asks
    every implicated peer to capture one too (their `/capsule/capture`
    endpoint), off-thread — the alert evaluation cycle must never block
    on capsule I/O.

    `peers_fn(alert_row) -> [host:port, ...]` names the implicated
    nodes: the master passes the alert's target when it looks like a
    node, or the up scrape targets for cluster-scoped alerts (an SLO
    objective burning implicates everyone serving it)."""

    def __init__(self, node: str = "", peers_fn=None, enabled_fn=None):
        self.node = node
        self.peers_fn = peers_fn
        self.enabled_fn = enabled_fn
        self._lock = threading.Lock()
        self._threads: list[threading.Thread] = []

    def __call__(self, alert_row: dict) -> None:
        if self.enabled_fn is not None and not self.enabled_fn():
            return
        key = f"{alert_row.get('Alert')}@{alert_row.get('Target')}"
        if not should_autocapture(key):
            return
        t = threading.Thread(
            target=self._run, args=(alert_row, key), daemon=True,
            name="capsule-capture",
        )
        with self._lock:
            self._threads = [w for w in self._threads if w.is_alive()]
            self._threads.append(t)
        t.start()

    def join(self, timeout: float = 60.0) -> None:
        """Wait for every capture this coordinator started."""
        with self._lock:
            threads, self._threads = self._threads, []
        for t in threads:
            t.join(timeout)

    def _run(self, alert_row: dict, key: str) -> None:
        reason = f"alert-{key}"
        try:
            capture(reason, trigger="alert", node=self.node)
        except Exception as e:  # noqa: BLE001 — capture must not throw
            wlog.warning("capsule: local capture failed: %r", e)
        for url in self._peers(alert_row):
            try:
                q = urllib.parse.urlencode(
                    {"reason": reason, "trigger": "alert"}
                )
                with urllib.request.urlopen(
                    f"http://{url}/capsule/capture?{q}", timeout=10.0
                ) as r:
                    r.read()
            except OSError as e:
                wlog.warning(
                    "capsule: remote capture on %s failed: %r", url, e
                )

    def _peers(self, alert_row: dict) -> list[str]:
        if self.peers_fn is None:
            return []
        try:
            peers = list(self.peers_fn(alert_row) or ())
        except Exception:  # noqa: BLE001
            return []
        return [u for u in peers if u and u != self.node]
