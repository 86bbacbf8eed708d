"""Scrub verify cores: EC parity re-verify with culprit localization,
and the plain-volume needle CRC walk.

The EC path is the product face of the verify tier that until now only
the `ec.verify` shell command exercised (parallel/mesh_codec
verify_batch_u32 / the SWAR host path feed `rs.encode` through
ec/codec.py's backend selection): stream all 14 shards tile by tile,
recompute the 4 parity rows from the 10 data rows, and compare. A
corrupt DATA shard disagrees with every parity row; a corrupt PARITY
shard only with its own. Localization then pins the culprit shard(s)
by hypothesis testing: reconstruct candidate set S from the other
shards; if every member of S changes AND the repaired tile passes a
full parity check, S is the corrupt set. Singles then pairs — beyond
two simultaneously-corrupt shards in one 4 MiB tile the sweep reports
the tile unlocalized rather than guessing (quarantining a healthy
shard on a guess costs real redundancy).

The port of seaweedfs_tpu/scrub/verify.py. `rs` is the caller's codec
(an EC volume's, or new_encoder()'s default): on the cuda backend a
tile's parity re-encode is one K1 launch, [10, tile] -> [4], and each
localization hypothesis is a K1 decode of its missing data rows and a
K1 re-encode (decodes under 64 KiB take K5).
"""

from __future__ import annotations

import threading
from dataclasses import dataclass, field
from itertools import combinations
from typing import Callable, Optional, Sequence

import numpy as np

from seaweedfs_tpu_torch.ec.codec import ReedSolomon, new_encoder
from seaweedfs_tpu_torch.scrub.ratelimit import TokenBucket
from seaweedfs_tpu_torch.storage import types as t
from seaweedfs_tpu_torch.storage.needle import CorruptNeedle, get_actual_size
from seaweedfs_tpu_torch.storage.volume import NeedleNotFound

DEFAULT_TILE_BYTES = 4 * 1024 * 1024

# reader(offset, size) -> bytes; short return means EOF
ShardReader = Callable[[int, int], bytes]


@dataclass
class ParityScanResult:
    # per-parity-row mismatched byte counts (the ec.verify contract)
    mismatch: list[int]
    bytes_per_shard: int = 0  # verified by THIS call
    bad_tiles: list[tuple[int, int]] = field(default_factory=list)
    # sid -> number of bad tiles localized to it
    culprits: dict[int, int] = field(default_factory=dict)
    unlocalized: int = 0  # bad tiles no 1- or 2-shard hypothesis explains
    end_offset: int = 0
    complete: bool = False  # swept through shard EOF
    aborted: bool = False  # stop event fired mid-scan

    @property
    def corrupt(self) -> bool:
        return any(self.mismatch)


def verify_parity_stream(
    readers: Sequence[ShardReader],
    *,
    rs: ReedSolomon | None = None,
    start: int = 0,
    tile_bytes: int = DEFAULT_TILE_BYTES,
    limiter: TokenBucket | None = None,
    stop: threading.Event | None = None,
    max_bytes: int | None = None,
    localize: bool = True,
) -> ParityScanResult:
    """Stream every shard from `start`, recompute + compare parity per
    tile. `max_bytes` bounds the PER-SHARD bytes verified this call
    (the engine's incremental-sweep budget); the cursor to resume from
    is `end_offset`."""
    rs = rs or new_encoder()
    k, total = rs.data_shards, rs.total_shards
    if len(readers) != total:
        raise ValueError(f"expected {total} shard readers, got {len(readers)}")
    res = ParityScanResult(mismatch=[0] * rs.parity_shards, end_offset=start)
    offset = start
    while True:
        if stop is not None and stop.is_set():
            res.aborted = True
            break
        if max_bytes is not None and res.bytes_per_shard >= max_bytes:
            break
        # charge per SHARD read, not per 14-shard tile: one tile's
        # worth (tile_bytes x 14 = 56 MiB at the default tile) would
        # dwarf any sane burst and turn the pacing into start-of-sweep
        # storms — exactly the foreground-p99 spikes the bucket exists
        # to prevent. Charged AFTER the read, for the bytes actually
        # returned: the debt model keeps the long-run rate exact while
        # short final tiles and the zero-byte EOF probe cost nothing
        # (pre-charging the nominal tile wastes ~1 s of budget per
        # volume per sweep on exactly-tile-aligned shards).
        tiles = []
        for sid in range(total):
            if limiter is not None and stop is not None and stop.is_set():
                res.aborted = True
                return res
            data = readers[sid](offset, tile_bytes)
            if limiter is not None and not limiter.take(len(data), stop):
                res.aborted = True
                return res
            tiles.append(data)
        n = len(tiles[0])
        if any(len(tile) != n for tile in tiles):
            lens = [len(tile) for tile in tiles]
            raise RuntimeError(f"shard length skew at {offset}: {lens}")
        if n == 0:
            res.complete = True
            break
        shards: list[Optional[np.ndarray]] = [
            np.frombuffer(tiles[i], dtype=np.uint8).copy() for i in range(k)
        ] + [None] * rs.parity_shards
        rs.encode(shards)
        tile_bad = False
        for p in range(rs.parity_shards):
            given = np.frombuffer(tiles[k + p], dtype=np.uint8)
            bad = int(np.count_nonzero(shards[k + p] != given))
            if bad:
                tile_bad = True
                res.mismatch[p] += bad
        if tile_bad:
            res.bad_tiles.append((offset, n))
            if localize:
                culprits = localize_corrupt_shards(tiles, rs)
                if culprits is None:
                    res.unlocalized += 1
                else:
                    for sid in culprits:
                        res.culprits[sid] = res.culprits.get(sid, 0) + 1
        res.bytes_per_shard += n
        offset += n
        res.end_offset = offset
        if n < tile_bytes:
            res.complete = True
            break
    return res


def localize_corrupt_shards(
    tiles: Sequence[bytes], rs: ReedSolomon | None = None
) -> list[int] | None:
    """Which shard(s) hold the wrong bytes for this tile? Hypothesis
    test over 1- then 2-shard candidate sets; None when unexplained."""
    rs = rs or new_encoder()
    k, total = rs.data_shards, rs.total_shards
    arrays = [np.frombuffer(tile, dtype=np.uint8) for tile in tiles]

    def reconstructed(targets: tuple[int, ...]) -> dict[int, np.ndarray] | None:
        shards: list[Optional[np.ndarray]] = [
            None if i in targets else arrays[i].copy() for i in range(total)
        ]
        try:
            rs.reconstruct(shards)
        except Exception:  # noqa: BLE001 - not enough clean survivors
            return None
        return {i: shards[i] for i in targets}  # type: ignore[misc]

    def parity_clean(repl: dict[int, np.ndarray]) -> bool:
        shards: list[Optional[np.ndarray]] = [
            repl.get(i, arrays[i]).copy() for i in range(k)
        ] + [None] * rs.parity_shards
        rs.encode(shards)
        for p in range(rs.parity_shards):
            want = repl.get(k + p, arrays[k + p])
            if not np.array_equal(shards[k + p], want):
                return False
        return True

    for r in (1, 2):
        for combo in combinations(range(total), r):
            repl = reconstructed(combo)
            if repl is None:
                continue
            # every member of the hypothesis must actually change —
            # else a smaller set explains it (and was already tried)
            if any(np.array_equal(repl[i], arrays[i]) for i in combo):
                continue
            if parity_clean(repl):
                return list(combo)
    return None


# ---------------------------------------------------------------------------
# EC volumes with a fresh .ecc sidecar: plain read+CRC pass per shard


@dataclass
class EccScanResult:
    """Resume state for the sidecar-CRC sweep: (shard_idx, offset,
    run_crc) is the cursor triple — the engine persists it so a
    restart mid-shard keeps the running CRC instead of rereading."""

    bytes_scanned: int = 0  # total bytes read by THIS call
    bad_shards: dict[int, str] = field(default_factory=dict)
    shard_idx: int = 0
    offset: int = 0
    run_crc: int = 0
    complete: bool = False
    aborted: bool = False

    @property
    def corrupt(self) -> bool:
        return bool(self.bad_shards)


def verify_ecc_stream(
    shard_paths: dict[int, str],
    doc: dict,
    *,
    start_shard: int = 0,
    start_offset: int = 0,
    run_crc: int = 0,
    tile_bytes: int = DEFAULT_TILE_BYTES,
    limiter: TokenBucket | None = None,
    stop: threading.Event | None = None,
    max_bytes: int | None = None,
) -> EccScanResult:
    """Verify shard files against their `.ecc`-attested whole-file
    CRC-32C + size (ec/ecc_sidecar.py): a sequential read + running
    CRC per shard, no GF math — the cheap arm of the EC scrub.

    Same pacing contract as verify_parity_stream: the limiter is
    charged AFTER each read for the bytes actually returned (debt
    model), `max_bytes` bounds the TOTAL bytes this call reads (the
    engine's segment budget), and the cursor triple to resume from is
    (shard_idx, offset, run_crc). Unlike the parity sweep this pins
    the culprit directly: a CRC or size mismatch names its shard."""
    from seaweedfs_tpu_torch.util.crc import crc32c

    res = EccScanResult(
        shard_idx=start_shard, offset=start_offset, run_crc=run_crc
    )
    # one reused read buffer: at several GB/s the per-tile bytes
    # allocation of a plain f.read is a measurable fraction of the pass
    buf = memoryview(bytearray(tile_bytes))
    sids = sorted(shard_paths)
    # resume position may name a shard that was quarantined since
    idx = next((i for i, s in enumerate(sids) if s >= start_shard), len(sids))
    if idx < len(sids) and sids[idx] != start_shard:
        res.offset, res.run_crc = 0, 0
    while idx < len(sids):
        sid = sids[idx]
        res.shard_idx = sid
        ent = doc["shards"].get(str(sid))
        if ent is None:
            # callers gate on sidecar_status == ok, but the sidecar can
            # be republished under us; treat as corrupt-signal for the
            # caller to fall back on
            res.bad_shards[sid] = "no sidecar entry"
            idx += 1
            res.offset, res.run_crc = 0, 0
            continue
        try:
            # buffering=0: raw FileIO reads straight into the reused
            # buffer, skipping the BufferedReader copy layer
            with open(shard_paths[sid], "rb", buffering=0) as f:
                if res.offset:
                    f.seek(res.offset)
                while True:
                    if stop is not None and stop.is_set():
                        res.aborted = True
                        return res
                    if max_bytes is not None and res.bytes_scanned >= max_bytes:
                        return res
                    got = f.readinto(buf)
                    if limiter is not None and not limiter.take(got, stop):
                        res.aborted = True
                        return res
                    if not got:
                        break
                    res.run_crc = crc32c(buf[:got], res.run_crc)
                    res.offset += got
                    res.bytes_scanned += got
        except OSError as e:
            res.bad_shards[sid] = f"read failed: {e!r}"
            idx += 1
            res.offset, res.run_crc = 0, 0
            continue
        if res.offset != ent.get("size"):
            res.bad_shards[sid] = (
                f"size {res.offset} != attested {ent.get('size')}"
            )
        elif res.run_crc != ent.get("crc"):
            res.bad_shards[sid] = (
                f"crc {res.run_crc:#010x} != attested {ent.get('crc'):#010x}"
            )
        idx += 1
        res.offset, res.run_crc = 0, 0
        res.shard_idx = sids[idx] if idx < len(sids) else sids[-1] + 1
    res.complete = True
    return res


# ---------------------------------------------------------------------------
# plain volumes: re-read every live needle through the CRC check


@dataclass
class PlainScanResult:
    scanned_bytes: int = 0
    corruptions: list[tuple[int, str]] = field(default_factory=list)
    last_key: int = 0
    consumed: int = 0  # entries of `keys` iterated (callers slice)
    complete: bool = False
    aborted: bool = False


def live_needle_keys(volume, after_key: int = 0) -> list[int]:
    """Sorted live needle ids > after_key — the sweep's work list.
    Split out so segmented callers enumerate/sort the map ONCE per
    volume pass instead of once per 64 MiB segment (O(segments x
    needles) of GIL-burning overhead on a big volume otherwise).

    Enumerates under the volume's write lock: nm.items() is a lazy
    generator over the live dict, and a concurrent foreground write
    mutating the map mid-iteration would raise RuntimeError and abort
    the whole sweep. Writers hold the same lock (write_needle), so one
    brief exclusion here is the correct snapshot."""
    with volume._lock:
        return sorted(
            nv.key
            for nv in volume.nm.items()
            if nv.key > after_key
            and nv.offset != 0
            and nv.size != t.TOMBSTONE_FILE_SIZE
        )


def scan_plain_volume(
    volume,
    *,
    after_key: int = 0,
    keys: list[int] | None = None,
    limiter: TokenBucket | None = None,
    stop: threading.Event | None = None,
    max_bytes: int | None = None,
) -> PlainScanResult:
    """Re-read every live needle with id > after_key through the full
    parse + CRC32-C check (Needle.from_bytes raises CorruptNeedle on a
    flipped byte). Walks the NEEDLE MAP, not the raw .dat: the map is
    exactly the reachable set — overwritten generations and tombstones
    are dead bytes whose rot cannot hurt a read, and a framing walk of
    a corrupt .dat would desync and drown the report in false hits.

    `keys` (from live_needle_keys) lets a segmented caller reuse one
    enumeration across segments; result.consumed says how many entries
    this call got through, so the caller can slice."""
    from seaweedfs_tpu_torch.storage.volume import CookieMismatch

    res = PlainScanResult(last_key=after_key)
    live = keys if keys is not None else live_needle_keys(volume, after_key)
    res.complete = True
    for key in live:
        if stop is not None and stop.is_set():
            res.aborted = True
            res.complete = False
            break
        nv = volume.nm.get(key)
        if nv is None or nv.offset == 0 or nv.size == t.TOMBSTONE_FILE_SIZE:
            res.consumed += 1
            res.last_key = key
            continue  # deleted since the snapshot
        record = get_actual_size(nv.size, volume.version)
        # budget check only after progress: a single record larger than
        # the whole budget must still scan (else the caller's
        # segment loop would spin forever at zero progress)
        if (
            max_bytes is not None
            and res.scanned_bytes
            and res.scanned_bytes + record > max_bytes
        ):
            res.complete = False
            break
        if limiter is not None and not limiter.take(record, stop):
            res.aborted = True
            res.complete = False
            break
        try:
            volume.read_needle(key)
        except CorruptNeedle as e:
            res.corruptions.append((key, str(e)))
        except (NeedleNotFound, CookieMismatch):
            pass  # deleted/expired between snapshot and read
        except Exception as e:  # noqa: BLE001 - EIO, parse desync, ...
            # a latent sector error (OSError) or a framing/parse blowup
            # is exactly the damage a scrubber exists to find — record
            # it and keep sweeping; letting it propagate would wedge
            # the engine at this cursor forever (every sweep re-crashes
            # on the same needle and nothing after it is ever scanned)
            res.corruptions.append((key, f"read failed: {e!r}"))
        res.scanned_bytes += record
        res.consumed += 1
        res.last_key = key
    return res
