"""Volume-server tier engine: move a sealed EC volume's local shards
to an object-store backend and back (docs/TIERING.md).

Tier-out ordering (crash-safe without a journal):

  1. upload every local shard via `backend.copy_file` (each upload is
     itself atomic on the backend side — .part then rename for the
     dir backend, single PUT for s3), charging the bandwidth arbiter's
     "tier" claimant as the bytes stream;
  2. durably publish the `.evf` attachment sidecar
     (EcVolume.attach_remote — write tmp, fsync, rename, dirsync);
  3. delete the local shard files.

A crash before (2) leaves local data intact and the uploads as
re-uploadable orphans; after (2) both copies exist and local wins.
The `.ecx`/`.ecj`/`.ecc` sidecars always stay local — needle lookup
and delete-journal replay never touch the backend.

Tier-in downloads each shard to a temp name, verifies its whole-file
CRC-32C against the `.ecc` scrub sidecar when one exists (a backend
that rotted or truncated a shard is caught BEFORE the bytes are
trusted locally), durably publishes it at the shard path, mounts it,
then detaches the `.evf` and best-effort deletes the remote keys.
"""

from __future__ import annotations

import os
import threading

from seaweedfs_tpu_torch.ec import ec_files
from seaweedfs_tpu_torch.ec.ec_volume import RemoteEcAttachment
from seaweedfs_tpu_torch.ec.ecc_sidecar import load_sidecar
from seaweedfs_tpu_torch.scrub.arbiter import get_arbiter
from seaweedfs_tpu_torch.storage import backend as bk
from seaweedfs_tpu_torch.util import durable, wlog
from seaweedfs_tpu_torch.util.crc import crc32c

_READ_CHUNK = 4 << 20


def _arbiter_progress(stop: threading.Event | None):
    """progress(done, pct) callback that charges the "tier" claimant
    for each new chunk the backend copy reports."""
    arb = get_arbiter()
    last = [0]

    def progress(done: int, pct: float) -> None:
        delta = done - last[0]
        last[0] = done
        if delta > 0:
            arb.take("tier", delta, stop=stop)

    return progress


def _file_crc32c(path: str) -> int:
    crc = 0
    with open(path, "rb") as f:
        while True:
            chunk = f.read(_READ_CHUNK)
            if not chunk:
                break
            crc = crc32c(chunk, crc)
    return crc


def tiered_volume_count(store) -> int:
    n = 0
    for loc in store.locations:
        for ev in list(loc.ec_volumes.values()):
            if getattr(ev, "remote", None) is not None:
                n += 1
    return n


def _update_tiered_gauge(store) -> None:
    from seaweedfs_tpu_torch.stats.metrics import TIERED_VOLUMES

    TIERED_VOLUMES.set(tiered_volume_count(store), store.node_label)


def tier_status(store) -> dict:
    """Per-EC-volume tier state on this server — the /tier/status
    surface the master's TierScheduler polls (shard mtimes feed the
    age signal; Tiered feeds the direction decision)."""
    out: dict[str, dict] = {}
    for loc in store.locations:
        for vid, ev in list(loc.ec_volumes.items()):
            newest_mtime = 0.0
            local = sorted(ev.shards)
            for sid in local:
                try:
                    newest_mtime = max(
                        newest_mtime, os.path.getmtime(ev.shards[sid].path)
                    )
                except (OSError, KeyError):
                    continue
            remote = getattr(ev, "remote", None)
            out[str(vid)] = {
                "Collection": ev.collection,
                "LocalShards": local,
                "Tiered": remote is not None,
                "Backend": remote.backend_name if remote else "",
                "RemoteShards": sorted(remote.shards) if remote else [],
                "NewestShardMtime": newest_mtime,
            }
    return out


def tier_out_ec(
    store, vid: int, backend_name: str, stop: threading.Event | None = None
) -> dict:
    """Move every local shard of EC volume `vid` to `backend_name`.
    Returns a summary dict; raises on any failure (uploaded orphans
    are best-effort deleted so a retry starts clean)."""
    from seaweedfs_tpu_torch.stats.metrics import TIER_BYTES, TIER_MOVES

    ev = store.find_ec_volume(vid)
    if ev is None:
        raise ValueError(f"ec volume {vid} not found on this server")
    if ev.remote is not None:
        return {"VolumeId": vid, "AlreadyTiered": True}
    bk.ensure_builtin_factories()
    backend = bk.get_backend(backend_name)
    if backend is None:
        raise ValueError(f"backend {backend_name!r} not configured")
    progress = _arbiter_progress(stop)
    shards: dict[int, dict] = {}
    shard_size = 0
    moved_bytes = 0
    try:
        for sid in ev.shard_ids():
            path = ev.shards[sid].path
            size = os.path.getsize(path)
            key, copied = backend.copy_file(
                path, {"ext": ec_files.to_ext(sid)}, progress
            )
            shards[sid] = {"key": key, "size": copied}
            shard_size = max(shard_size, copied)
            moved_bytes += copied
            progress = _arbiter_progress(stop)  # fresh delta per shard
    except Exception:
        TIER_MOVES.labels("out", "error").inc()
        # undo the partial upload so a retry doesn't leak keys
        for info in shards.values():
            try:
                backend.delete_file(info["key"])
            except OSError:
                pass
        raise
    # the durable .evf publish is the commit point: from here the
    # remote copies are authoritative enough to delete local bytes
    ev.attach_remote(
        RemoteEcAttachment(backend.name, shard_size, shards)
    )
    for sid in list(ev.shards):
        shard = ev.shards.pop(sid)
        shard.close()
        try:
            os.remove(shard.path)
        except OSError as e:
            wlog.warning("tier-out vid %d: remove %s: %s", vid, shard.path, e)
    TIER_MOVES.labels("out", "ok").inc()
    TIER_BYTES.labels("out").inc(moved_bytes)
    _update_tiered_gauge(store)
    store.notify_change()
    wlog.warning(
        "tier: vid %d out to %s (%d shard(s), %d bytes)",
        vid, backend.name, len(shards), moved_bytes,
    )
    return {
        "VolumeId": vid,
        "Backend": backend.name,
        "Shards": sorted(shards),
        "Bytes": moved_bytes,
    }


def tier_in_ec(store, vid: int, stop: threading.Event | None = None) -> dict:
    """Recall EC volume `vid` from its backend: download, CRC-verify
    against the .ecc sidecar, durably publish, mount, detach."""
    from seaweedfs_tpu_torch.stats.metrics import TIER_BYTES, TIER_MOVES

    ev = store.find_ec_volume(vid)
    if ev is None:
        raise ValueError(f"ec volume {vid} not found on this server")
    remote = ev.remote
    if remote is None:
        return {"VolumeId": vid, "NotTiered": True}
    bk.ensure_builtin_factories()
    backend = bk.get_backend(remote.backend_name)
    if backend is None:
        raise ValueError(
            f"backend {remote.backend_name!r} not configured on this "
            f"server (load storage config before recalling)"
        )
    ecc = load_sidecar(ev.base_name)
    moved_bytes = 0
    restored: list[int] = []
    try:
        for sid in sorted(remote.shards):
            if sid in ev.shards:
                continue  # kept local (keep_local tier-out, or partial)
            info = remote.shards[sid]
            dst = ev.base_name + ec_files.to_ext(sid)
            tmp = dst + ".tierin"
            backend.download_file(tmp, info["key"], _arbiter_progress(stop))
            got = os.path.getsize(tmp)
            if got != info["size"]:
                raise IOError(
                    f"shard {sid}: backend returned {got} of "
                    f"{info['size']} bytes"
                )
            if ecc is not None:
                want = ecc["shards"].get(str(sid))
                if want is not None and _file_crc32c(tmp) != want["crc"]:
                    raise IOError(
                        f"shard {sid}: CRC mismatch against .ecc sidecar "
                        f"— backend copy is corrupt; keeping remote "
                        f"attachment"
                    )
            durable.publish(tmp, dst)
            ev.mount_shard(sid)
            restored.append(sid)
            moved_bytes += got
    except Exception:
        TIER_MOVES.labels("in", "error").inc()
        # partial recall is fine: local shards win on reads, the .evf
        # still covers the rest — retry resumes where this stopped
        raise
    finally:
        for sid in sorted(remote.shards):
            tmp = ev.base_name + ec_files.to_ext(sid) + ".tierin"
            try:
                os.remove(tmp)
            except OSError:
                pass
    ev.detach_remote()
    for info in remote.shards.values():
        try:
            backend.delete_file(info["key"])
        except OSError as e:
            wlog.warning("tier-in vid %d: delete remote key: %s", vid, e)
    TIER_MOVES.labels("in", "ok").inc()
    TIER_BYTES.labels("in").inc(moved_bytes)
    _update_tiered_gauge(store)
    store.notify_change()
    wlog.warning(
        "tier: vid %d recalled from %s (%d shard(s), %d bytes)",
        vid, remote.backend_name, len(restored), moved_bytes,
    )
    return {
        "VolumeId": vid,
        "Backend": remote.backend_name,
        "Shards": restored,
        "Bytes": moved_bytes,
    }
