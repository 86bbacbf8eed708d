"""`.ecc` sidecar: persisted encode-time shard CRCs for cheap scrub.

The port's encode and rebuild drivers hand back a whole-file CRC-32C
per shard, computed on the card by K4 while each tile is resident.
`write_sidecar` persists them as a per-volume ``{base}.ecc`` JSON
document in the format seaweedfs_tpu/ec/ecc_sidecar.py defines (the
volume server's scrubber reads it), so a scrub can check shards with a
plain read+CRC pass instead of a parity re-verify.

Crash ordering: the sidecar ATTESTS shard bytes, so callers write it
only after the shard files are fsynced (durable=True on the drivers),
and it publishes through util/durable.publish (fsync bytes → rename →
fsync dir).

`sidecar_status` is the scrubber's freshness check: a sidecar older
than a shard it attests, or disagreeing with a shard's on-disk size,
is stale. Rebuilt shards are byte-identical to the originals, but their
files are newer, so the rebuild verbs merge the fresh CRCs and
republish. ``WEED_EC_ECC=0`` disables both emit and verify.
"""

from __future__ import annotations

import json
import os

from seaweedfs_tpu_torch.util import durable

ECC_EXT = ".ecc"
_VERSION = 1


def ecc_enabled() -> bool:
    """`WEED_EC_ECC` env knob: any value but "0" keeps the sidecar
    emit + scrub verify on."""
    return os.environ.get("WEED_EC_ECC", "1") != "0"


def sidecar_path(base: str) -> str:
    return base + ECC_EXT


def load_sidecar(base: str) -> dict | None:
    """Parsed sidecar doc, or None when absent/unreadable/garbled (a
    torn sidecar must degrade to the parity path, not crash a sweep)."""
    try:
        with open(sidecar_path(base), "r", encoding="utf-8") as f:
            doc = json.load(f)
    except (OSError, ValueError):
        return None
    if not isinstance(doc, dict) or not isinstance(doc.get("shards"), dict):
        return None
    return doc


def write_sidecar(
    base: str,
    crcs,
    *,
    total_shards: int = 14,
) -> str | None:
    """Publish ``{base}.ecc`` attesting per-shard whole-file CRC + size.

    `crcs` is either a full [total_shards] list (the generate verbs) or
    a partial {sid: crc} dict (the rebuild verbs), merged over any
    existing sidecar. A partial update with no prior sidecar cannot
    attest the untouched shards and is skipped (returns None) — the
    scrubber then takes the parity path for this volume until the next
    full generate.

    PRECONDITION: the shard files' bytes are already durable (the
    callers' durable=True fsync)."""
    if isinstance(crcs, dict):
        entries = {int(k): int(v) for k, v in crcs.items()}
        existing = load_sidecar(base)
        if existing is not None:
            for k, v in existing["shards"].items():
                entries.setdefault(int(k), int(v["crc"]))
        if len(entries) < total_shards:
            return None
    else:
        if len(crcs) != total_shards:
            raise ValueError(
                f"expected {total_shards} shard CRCs, got {len(crcs)}"
            )
        entries = {sid: int(c) for sid, c in enumerate(crcs)}

    from seaweedfs_tpu_torch.ec import ec_files

    shards = {}
    for sid in range(total_shards):
        path = base + ec_files.to_ext(sid)
        try:
            size = os.path.getsize(path)
        except OSError:
            return None  # shard vanished under us: attest nothing
        shards[str(sid)] = {"crc": entries[sid] & 0xFFFFFFFF, "size": size}

    dst = sidecar_path(base)
    tmp = dst + ".tmp"
    with open(tmp, "w", encoding="utf-8") as f:
        json.dump({"version": _VERSION, "shards": shards}, f)
    durable.publish(tmp, dst)
    return dst


def sidecar_status(
    base: str, shard_paths: dict[int, str], total_shards: int = 14
) -> tuple[str, dict | None]:
    """("ok", doc) when the sidecar attests every shard in
    `shard_paths` and is no older than any of them; ("missing", None) /
    ("stale", doc-or-None) otherwise. Size disagreement and
    shard-newer-than-sidecar both count as stale (the attested CRCs may
    describe bytes that are no longer on disk)."""
    doc = load_sidecar(base)
    if doc is None:
        return "missing", None
    try:
        ecc_mtime = os.stat(sidecar_path(base)).st_mtime_ns
    except OSError:
        return "missing", None
    for sid, path in shard_paths.items():
        ent = doc["shards"].get(str(sid))
        if ent is None:
            return "stale", doc
        try:
            st = os.stat(path)
        except OSError:
            return "stale", doc
        if st.st_size != ent.get("size"):
            return "stale", doc
        if st.st_mtime_ns > ecc_mtime:
            return "stale", doc
    if len(doc["shards"]) < total_shards:
        return "stale", doc
    return "ok", doc
