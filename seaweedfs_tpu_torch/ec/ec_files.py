"""Streaming shard-file generation: .dat → .ec00….ec13, and rebuild.

Behavioral match of reference weed/storage/erasure_coding/ec_encoder.go:
  * two-tier striping: rows of 1 GB blocks while more than one full
    large row of data remains, then 1 MB rows, zero-padded at the tail
    (encodeDatFile:188-225 — note both loops use a strict `>` test);
  * each .ec file is that shard's blocks concatenated: all large-row
    blocks then all small-row blocks (encodeDataOneBatch writes all 14
    buffers, so .ec00-.ec09 hold plain data copies);
  * rebuild streams all surviving shards in lockstep chunks and
    reconstructs the missing ones positionwise (rebuildEcFiles:227-281);
  * .ecx = the .idx entries deduped last-wins and sorted ascending by
    key, same 16-byte entry format (WriteSortedFileFromIdx:26-50 via
    CompactMap.AscendingVisit — deleted keys stay, tombstoned);

The byte math goes through a codec.ReedSolomon. With the cuda backend
(the default) the pipelined ec_stream drivers run K1/K4 on the rs's
device; WEED_EC_PIPELINE=0 and the numpy "cpu" backend take the serial
classic loops below. Output bytes are identical on every arm.
write_ec_files_batch / rebuild_ec_files_batch run many volumes per
round through a parallel.MeshCodec (K2, K4).
"""

from __future__ import annotations

import os

import numpy as np

from seaweedfs_tpu_torch.ec import locate
from seaweedfs_tpu_torch.ec.codec import ReedSolomon, new_encoder
from seaweedfs_tpu_torch.storage import idx as idx_codec
from seaweedfs_tpu_torch.storage import types as t

DATA_SHARDS = locate.DATA_SHARDS
PARITY_SHARDS = locate.PARITY_SHARDS
TOTAL_SHARDS = locate.TOTAL_SHARDS
LARGE_BLOCK_SIZE = locate.LARGE_BLOCK_SIZE
SMALL_BLOCK_SIZE = locate.SMALL_BLOCK_SIZE

DEFAULT_BUFFER_SIZE = 4 * 1024 * 1024  # per-shard IO batch (ref used 256 KB)


def to_ext(ec_index: int) -> str:
    """Shard-file extension: ".ec00" … ".ec13" (ec_encoder.go ToExt)."""
    return f".ec{ec_index:02d}"


def shard_row_counts(
    dat_size: int,
    large: int = LARGE_BLOCK_SIZE,
    small: int = SMALL_BLOCK_SIZE,
) -> tuple[int, int]:
    """(large rows, small rows) a .dat of `dat_size` encodes to.

    Mirrors encodeDatFile's strict-greater loops: a file of exactly
    n·(10·large) bytes produces n-1 large rows (the last full row goes
    through the small-block tier)."""
    n_large = 0
    remaining = dat_size
    while remaining > large * DATA_SHARDS:
        n_large += 1
        remaining -= large * DATA_SHARDS
    n_small = 0
    while remaining > 0:
        n_small += 1
        remaining -= small * DATA_SHARDS
    return n_large, n_small


def shard_file_size(
    dat_size: int,
    large: int = LARGE_BLOCK_SIZE,
    small: int = SMALL_BLOCK_SIZE,
) -> int:
    """Bytes in each .ecNN file a .dat of `dat_size` encodes to."""
    n_large, n_small = shard_row_counts(dat_size, large, small)
    return n_large * large + n_small * small


def shard_presence(base_file_name: str) -> tuple[list[bool], list[int]]:
    """(present flags, missing ids) over the 14 shard files."""
    present = [
        os.path.exists(base_file_name + to_ext(i)) for i in range(TOTAL_SHARDS)
    ]
    return present, [i for i, p in enumerate(present) if not p]


def _use_stream_driver(rs: ReedSolomon) -> bool:
    """Route the cuda backend to the pipelined ec_stream driver, whose
    stage pairs run the kernels on rs.device (the card, or their plain
    versions when the caller built the codec with device="cpu").
    WEED_EC_PIPELINE=0 forces the serial classic loop wholesale."""
    from seaweedfs_tpu_torch.ec import ec_stream

    return rs._backend_name == "cuda" and ec_stream.pipeline_enabled()


def iter_ec_tiles(dat_size: int, tile: int, large: int, small: int):
    """Yield (row_offset, block_size, batch_off, step) sub-tiles
    covering the two-tier row layout (strict-`>` row counting,
    ec_encoder.go:188-225). The reader takes [10, step] at
    row_offset + i*block_size + batch_off for shard i. Single source
    of the tiling math for the classic and pipelined drivers."""
    n_large, n_small = shard_row_counts(dat_size, large, small)
    processed = 0
    for block_size, n_rows in ((large, n_large), (small, n_small)):
        step = min(tile, block_size)
        for _ in range(n_rows):
            for batch_off in range(0, block_size, step):
                yield processed, block_size, batch_off, min(
                    step, block_size - batch_off
                )
            processed += block_size * DATA_SHARDS


def read_dat_tile(
    dat, dat_size: int, row_off: int, block: int, batch_off: int, step: int
) -> np.ndarray:
    """[10, step] uint8 tile of the .dat, zero-padded past EOF
    (encodeDataOneBatch:158-170). Rows are read with readinto straight
    into the tile (file.read would allocate a bytes object and pay a
    second memcpy per row — at stream rates that extra pass is a
    measurable fraction of the whole read phase)."""
    buf = np.zeros((DATA_SHARDS, step), dtype=np.uint8)
    for i in range(DATA_SHARDS):
        off = row_off + i * block + batch_off
        if off >= dat_size:
            continue
        dat.seek(off)
        n = min(step, dat_size - off)
        view = memoryview(buf[i])
        got = 0
        while got < n:
            r = dat.readinto(view[got:n])
            if not r:
                break
            got += r
    return buf


def write_ec_files(
    base_file_name: str,
    rs: ReedSolomon | None = None,
    buffer_size: int | None = None,
    large_block_size: int = LARGE_BLOCK_SIZE,
    small_block_size: int = SMALL_BLOCK_SIZE,
    stats: dict | None = None,
    durable: bool = False,
    want_crcs: bool = False,
) -> None:
    """Generate .ec00-.ec13 next to `base_file_name`.dat
    (ec_encoder.go:53 WriteEcFiles). durable=True fsyncs the shard
    files before returning (see stream_write_ec_files — the ordering
    the generate verb's .ecx publish relies on after a crash).

    buffer_size=None lets each driver pick its default (4 MiB classic
    IO batches; 1 MiB pipelined tiles on the cuda backend). A `stats` dict
    collects per-phase busy seconds so e2e throughput numbers stay
    attributable: the classic loop reports
    read_s/encode_s/write_s; the pipelined stream driver reports
    read_s/stage_s/device_s/writeback_s/compute_s/write_s plus its
    pipeline depth (overlapped stages — each pool's busy seconds).

    want_crcs=True lands `shard_crcs` (14 whole-file CRC-32C values)
    in `stats` on every driver: fused into the device pass on the
    pipelined paths, a running table CRC on the classic loop — the
    value contract is identical, so the WEED_EC_PIPELINE=0 kill switch
    changes nothing callers can observe but speed."""
    rs = rs or new_encoder()
    if rs.data_shards != DATA_SHARDS or rs.parity_shards != PARITY_SHARDS:
        raise ValueError("shard-file layout is fixed at RS(10,4)")

    if _use_stream_driver(rs):
        from seaweedfs_tpu_torch.ec import ec_stream

        ec_stream.stream_write_ec_files(
            base_file_name,
            tile_bytes=buffer_size,
            large_block_size=large_block_size,
            small_block_size=small_block_size,
            stats=stats,
            durable=durable,
            want_crcs=want_crcs,
            device=rs.device,
        )
        return

    buffer_size = buffer_size or DEFAULT_BUFFER_SIZE
    for block in (large_block_size, small_block_size):
        if block % buffer_size != 0 and buffer_size % block != 0:
            raise ValueError("buffer size must tile the block sizes")

    import time as _time

    wall0 = _time.perf_counter()
    read_s = encode_s = write_s = 0.0
    crcs = [0] * TOTAL_SHARDS  # running per-shard-file CRC (want_crcs)
    dat_size = os.path.getsize(base_file_name + ".dat")
    outputs = [open(base_file_name + to_ext(i), "wb") for i in range(TOTAL_SHARDS)]
    try:
        from seaweedfs_tpu_torch.util.crc import crc32c

        with open(base_file_name + ".dat", "rb") as dat:
            for row_off, block, batch_off, step in iter_ec_tiles(
                dat_size, buffer_size, large_block_size, small_block_size
            ):
                t0 = _time.perf_counter()
                tile = read_dat_tile(dat, dat_size, row_off, block, batch_off, step)
                t1 = _time.perf_counter()
                shards: list[np.ndarray | None] = [
                    tile[i] for i in range(DATA_SHARDS)
                ] + [None] * PARITY_SHARDS
                rs.encode(shards)
                t2 = _time.perf_counter()
                for i in range(TOTAL_SHARDS):
                    # numpy arrays expose the buffer protocol: write the
                    # row directly instead of paying a tobytes() copy
                    outputs[i].write(shards[i])  # type: ignore[arg-type]
                    if want_crcs:
                        # the serial loop writes in stream order, so
                        # the table CRC simply continues — same value
                        # contract as the pipelined drivers' fused fold
                        crcs[i] = crc32c(shards[i], crcs[i])
                t3 = _time.perf_counter()
                read_s += t1 - t0
                encode_s += t2 - t1
                write_s += t3 - t2
        if durable:
            # success path only (inside the try): a failed durability
            # fsync must fail the encode, never be swallowed by close
            for f in outputs:
                f.flush()
                os.fsync(f.fileno())
    finally:
        tc0 = _time.perf_counter()
        try:
            for f in outputs:
                f.close()
        finally:
            for f in outputs:
                if not f.closed:  # a failed close must not leak the rest
                    try:
                        f.close()
                    except OSError:
                        pass
        flush_s = _time.perf_counter() - tc0
        if stats is not None:
            wall = _time.perf_counter() - wall0
            stats.update(
                read_s=round(read_s, 4),
                encode_s=round(encode_s, 4),
                write_s=round(write_s, 4),
                # closing 14 buffered writers is where the KERNEL's
                # dirty-page writeback throttling lands on disk-backed
                # paths — round 4's "40% unattributed wall" was exactly
                # this, not Python glue (on tmpfs it is ~0)
                flush_s=round(flush_s, 4),
                wall_s=round(wall, 4),
                # driver overhead outside every measured phase (tile
                # iteration, buffer setup): the e2e number is only
                # honest if this stays small (measured ~7% on tmpfs)
                loop_s=round(
                    wall - read_s - encode_s - write_s - flush_s, 4
                ),
            )
            if want_crcs:
                stats["shard_crcs"] = crcs


def rebuild_ec_files(
    base_file_name: str,
    rs: ReedSolomon | None = None,
    buffer_size: int | None = None,
    durable: bool = False,
    stats: dict | None = None,
    want_crcs: bool = False,
) -> list[int]:
    """Regenerate whichever .ec files are missing from the ones present
    (ec_encoder.go:83 generateMissingEcFiles). Returns rebuilt ids.

    buffer_size=None lets each driver pick its default (1 MiB classic
    batches; 512 KiB pipelined tiles on the cuda backend). want_crcs
    lands {rebuilt shard id: whole-file CRC-32C} in `stats` on every
    driver (see write_ec_files)."""
    rs = rs or new_encoder()
    if rs.data_shards != DATA_SHARDS or rs.parity_shards != PARITY_SHARDS:
        raise ValueError("shard-file layout is fixed at RS(10,4)")
    if _use_stream_driver(rs):
        from seaweedfs_tpu_torch.ec import ec_stream

        return ec_stream.stream_rebuild_ec_files(
            base_file_name,
            tile_bytes=buffer_size,
            durable=durable,
            stats=stats,
            want_crcs=want_crcs,
            device=rs.device,
        )
    buffer_size = buffer_size or SMALL_BLOCK_SIZE
    present, missing = shard_presence(base_file_name)
    if not missing:
        return []
    if sum(present) < rs.data_shards:
        raise ValueError(
            f"too few shard files to rebuild: {sum(present)} of {rs.data_shards}"
        )

    from seaweedfs_tpu_torch.stats.metrics import (
        EC_REPAIR_BYTES_READ,
        EC_REPAIR_BYTES_WRITTEN,
    )

    read_local = EC_REPAIR_BYTES_READ.labels("local")
    inputs = {
        i: open(base_file_name + to_ext(i), "rb")
        for i in range(TOTAL_SHARDS)
        if present[i]
    }
    outputs = {i: open(base_file_name + to_ext(i), "wb") for i in missing}
    crcs = {i: 0 for i in missing}  # running rebuilt-file CRCs (want_crcs)
    try:
        from seaweedfs_tpu_torch.util.crc import crc32c

        shard_size = os.path.getsize(
            base_file_name + to_ext(next(iter(inputs)))
        )
        offset = 0
        while offset < shard_size:
            step = min(buffer_size, shard_size - offset)
            shards: list[np.ndarray | None] = [None] * TOTAL_SHARDS
            for i, f in inputs.items():
                f.seek(offset)
                raw = f.read(step)
                if len(raw) != step:
                    raise ValueError(
                        f"ec shard {i} truncated: expected {step} at {offset}"
                    )
                read_local.inc(len(raw))
                shards[i] = np.frombuffer(raw, dtype=np.uint8)
            rs.reconstruct(shards)
            for i in missing:
                chunk = shards[i].tobytes()  # type: ignore[union-attr]
                outputs[i].write(chunk)
                if want_crcs:
                    crcs[i] = crc32c(chunk, crcs[i])
                EC_REPAIR_BYTES_WRITTEN.inc(step)
            offset += step
        if stats is not None and want_crcs:
            stats["shard_crcs"] = crcs
        if durable:
            for f in outputs.values():
                f.flush()
                os.fsync(f.fileno())
    except BaseException:
        # partial (or written-but-unsynced, when the durable fsync
        # failed) targets must not survive: shard_presence counts ANY
        # existing .ecNN as a valid shard, so a retry would see "not
        # missing", skip the rebuild AND the fsync, and a later crash
        # could lose the shard bytes under a complete .ecx — the same
        # contract the stream driver enforces on its failure paths
        for i in missing:
            try:
                os.remove(base_file_name + to_ext(i))
            except OSError:
                pass
        raise
    finally:
        for f in inputs.values():
            f.close()
        for f in outputs.values():
            f.close()
    return missing


def write_ec_files_batch(
    base_file_names: list[str],
    codec=None,
    tile_bytes: int | None = None,
    large_block_size: int = LARGE_BLOCK_SIZE,
    small_block_size: int = SMALL_BLOCK_SIZE,
    stats: dict | None = None,
    durable: bool = False,
    want_crcs: bool = False,
) -> None:
    """Encode N sealed volumes' .dat files through one MeshCodec round
    per tile: each round stacks one [10, W] tile per volume into a
    [B, 10, W/4]-lane batch (parallel/mesh_codec.py; K2 per device).
    Output bytes are identical to write_ec_files per volume — the
    reference's goroutine-per-volume encode fan-out
    (command_ec_encode.go:153), batched.

    The production arm is the pipelined driver
    (ec_stream.stream_write_ec_files_batch, fused shard CRCs when
    want_crcs). WEED_EC_PIPELINE=0 takes this serial per-round loop
    instead: byte-identical, no overlap, the same durable contract.
    codec=None provisions a mesh over every card and raises without
    one; shapes stay fixed across rounds (finished volumes contribute
    zero tiles that are discarded)."""
    from seaweedfs_tpu_torch.ec import ec_stream

    if not base_file_names:
        return
    if ec_stream.pipeline_enabled():
        ec_stream.stream_write_ec_files_batch(
            base_file_names,
            codec=codec,
            tile_bytes=tile_bytes,
            large_block_size=large_block_size,
            small_block_size=small_block_size,
            stats=stats,
            durable=durable,
            want_crcs=want_crcs,
        )
        return
    if codec is None:
        codec = ec_stream._default_mesh_codec(len(base_file_names))
    tile_bytes = tile_bytes or DEFAULT_BUFFER_SIZE
    for block in (large_block_size, small_block_size):
        if block % tile_bytes != 0 and tile_bytes % block != 0:
            raise ValueError("tile size must tile the block sizes")

    b = len(base_file_names)
    vol_axis, stripe = codec.mesh.devices.shape
    if b % vol_axis:
        raise ValueError(
            f"batch of {b} volumes does not shard over the mesh's "
            f"{vol_axis}-way 'vol' axis"
        )
    from seaweedfs_tpu_torch.util.crc import crc32c

    tiles: list[list] = []
    dats, sizes, outs = [], [], []
    try:
        for base in base_file_names:
            size = os.path.getsize(base + ".dat")
            sizes.append(size)
            dats.append(open(base + ".dat", "rb"))
            outs.append([open(base + to_ext(i), "wb") for i in range(TOTAL_SHARDS)])
            tiles.append(
                list(iter_ec_tiles(size, tile_bytes, large_block_size, small_block_size))
            )
        crcs = [[0] * TOTAL_SHARDS for _ in range(b)]
        if any(tiles):
            # one tile width for every round, rounded so the lane count
            # splits over the stripe axis in whole 1024-lane chunks
            max_step = max(step for ts in tiles for _, _, _, step in ts)
            gran = 4 * 1024 * stripe
            width = -(-max_step // gran) * gran
            batch = np.zeros((b, DATA_SHARDS, width), dtype=np.uint8)
            for r in range(max(len(ts) for ts in tiles)):
                batch[:] = 0
                steps = [0] * b
                for v in range(b):
                    if r >= len(tiles[v]):
                        continue  # volume done: zero tile, output discarded
                    row_off, block, batch_off, step = tiles[v][r]
                    batch[v, :, :step] = read_dat_tile(
                        dats[v], sizes[v], row_off, block, batch_off, step
                    )
                    steps[v] = step
                parity = np.asarray(
                    codec.encode_batch_u32(codec.shard_volumes(batch.view(np.uint32)))
                ).view(np.uint8)
                for v in range(b):
                    step = steps[v]
                    if not step:
                        continue
                    rows = [batch[v, i, :step] for i in range(DATA_SHARDS)]
                    rows += [parity[v, p, :step] for p in range(PARITY_SHARDS)]
                    for i, row in enumerate(rows):
                        outs[v][i].write(row)
                        if want_crcs:
                            crcs[v][i] = crc32c(row, crcs[v][i])
        if stats is not None and want_crcs:
            stats["shard_crcs"] = crcs
        if durable:
            # success path only: a failed fsync fails the encode
            for fs in outs:
                for f in fs:
                    f.flush()
                    os.fsync(f.fileno())
    except BaseException:
        # no partial (or written-but-unsynced) shard set may survive for
        # ANY volume: shard_presence counts any .ecNN as a valid shard
        for fs in outs:
            for f in fs:
                try:
                    f.close()
                except OSError:
                    pass
        for base in base_file_names:
            for i in range(TOTAL_SHARDS):
                try:
                    os.remove(base + to_ext(i))
                except OSError:
                    pass
        raise
    finally:
        for f in dats:
            f.close()
        for fs in outs:
            for f in fs:
                if not f.closed:
                    try:
                        f.close()
                    except OSError:
                        pass


def rebuild_ec_files_batch(
    base_file_names: list[str],
    codec=None,
    tile_bytes: int | None = None,
    stats: dict | None = None,
    durable: bool = False,
    want_crcs: bool = False,
) -> list[list[int]]:
    """Regenerate missing .ec files for N volumes, batched: volumes
    sharing a (survivors, targets) signature ride one MeshCodec decode
    round per tile (ec_stream.stream_rebuild_ec_files_batch; K2 per
    device) — the BatchRebuild verb's driver. Every survivor must be
    local.

    WEED_EC_PIPELINE=0 takes a serial per-volume rebuild_ec_files loop
    instead (the cuda backend on the codec's first device; the card
    when codec is None): byte-identical, same durable contract. Returns
    the rebuilt id lists in input order; want_crcs lands `shard_crcs`
    in stats as one {rebuilt id: whole-file CRC-32C} dict per volume on
    both arms."""
    from seaweedfs_tpu_torch.ec import ec_stream

    if not base_file_names:
        return []
    if ec_stream.pipeline_enabled():
        return ec_stream.stream_rebuild_ec_files_batch(
            base_file_names,
            codec=codec,
            tile_bytes=tile_bytes,
            stats=stats,
            durable=durable,
            want_crcs=want_crcs,
        )
    rs = new_encoder(backend="cuda", device=None if codec is None else codec.devices[0])
    results, all_crcs = [], []
    for base in base_file_names:
        s: dict = {}
        results.append(
            rebuild_ec_files(
                base, rs=rs, buffer_size=tile_bytes, durable=durable, stats=s,
                want_crcs=want_crcs,
            )
        )
        all_crcs.append(s.get("shard_crcs") or {})
    if stats is not None:
        stats["batch_volumes"] = len(base_file_names)
        if want_crcs:
            stats["shard_crcs"] = all_crcs
    return results


# --- .ecx sorted index ------------------------------------------------------

def compact_idx_entries(idx_data: bytes) -> bytes:
    """Replay .idx entries last-wins into sorted .ecx bytes.

    Mirrors readCompactMap + AscendingVisit (ec_encoder.go:283-302,
    compact_map.go): live entries are set; a delete tombstones an
    existing entry in place (the key stays, size=TombstoneFileSize)
    when the entry was inserted in ascending key order (the reference's
    sorted `values` array) — a delete of an out-of-order insert (the
    reference's `overflow` array) removes the key entirely, and a
    delete of a zero-size entry is a no-op (CompactSection.Delete only
    tombstones Size > 0). Unknown keys are ignored."""
    state: dict[int, tuple[int, int]] = {}
    in_order: dict[int, bool] = {}
    max_key_seen = -1
    for key, offset, size in idx_codec.iter_entries(idx_data):
        if offset != 0 and size != t.TOMBSTONE_FILE_SIZE:
            if key not in state:
                in_order[key] = key > max_key_seen
            state[key] = (offset, size)
            max_key_seen = max(max_key_seen, key)
        else:
            old = state.get(key)
            if old is None:
                continue
            if not in_order.get(key, True):
                del state[key]  # overflow entries are removed outright
            elif old[1] > 0 and old[1] != t.TOMBSTONE_FILE_SIZE:
                state[key] = (old[0], t.TOMBSTONE_FILE_SIZE)
    keys = np.array(sorted(state), dtype=np.uint64)
    offsets = np.array([state[int(k)][0] for k in keys], dtype=np.uint64)
    sizes = np.array([state[int(k)][1] for k in keys], dtype=np.uint32)
    return idx_codec.arrays_to_entries(keys, offsets, sizes)


def write_sorted_file_from_idx(
    base_file_name: str, ext: str = ".ecx", durable: bool = False
) -> None:
    """.idx → sorted .ecx (ec_encoder.go:26 WriteSortedFileFromIdx).

    durable=True routes through util/durable.publish (tmp + fsync +
    rename + dirsync): the .ecx is the encode's commit record — if a
    crash leaves it visible, the shard files it indexes must be whole,
    so the generate verbs fsync shards first and publish this last
    (weedcrash ec-encode workload, docs/ANALYSIS.md v3)."""
    with open(base_file_name + ".idx", "rb") as f:
        idx_data = f.read()
    entries = compact_idx_entries(idx_data)
    if durable:
        from seaweedfs_tpu_torch.util import durable as _durable

        tmp = base_file_name + ext + ".tmp"
        with open(tmp, "wb") as f:
            f.write(entries)
        _durable.publish(tmp, base_file_name + ext)
        return
    with open(base_file_name + ext, "wb") as f:
        f.write(entries)


def write_idx_file_from_ec_index(base_file_name: str) -> None:
    """.ecx (+ .ecj tombstones) → .idx, for decoding shards back to a
    normal volume (ec_decoder.go:17 WriteIdxFileFromEcIndex)."""
    with open(base_file_name + ".ecx", "rb") as f:
        ecx = f.read()
    out = bytearray(ecx)
    ecj_path = base_file_name + ".ecj"
    if os.path.exists(ecj_path):
        with open(ecj_path, "rb") as f:
            ecj = f.read()
        for off in range(0, len(ecj) - t.NEEDLE_ID_SIZE + 1, t.NEEDLE_ID_SIZE):
            key = t.bytes_to_needle_id(ecj[off : off + t.NEEDLE_ID_SIZE])
            out += idx_codec.pack_entry(key, 0, t.TOMBSTONE_FILE_SIZE)
    with open(base_file_name + ".idx", "wb") as f:
        f.write(bytes(out))


def find_dat_file_size(base_file_name: str, version: int) -> int:
    """Max (offset + record size) over live .ecx entries
    (ec_decoder.go:47 FindDatFileSize)."""
    from seaweedfs_tpu_torch.storage.needle import get_actual_size

    with open(base_file_name + ".ecx", "rb") as f:
        ecx = f.read()
    dat_size = 0
    for key, offset, size in idx_codec.iter_entries(ecx):
        if size == t.TOMBSTONE_FILE_SIZE:
            continue
        end = t.units_to_offset(offset) + get_actual_size(size, version)
        dat_size = max(dat_size, end)
    return dat_size


def read_shard_intervals(
    base_file_name: str,
    offset: int,
    size: int,
    dat_size: int,
    large_block_size: int = LARGE_BLOCK_SIZE,
    small_block_size: int = SMALL_BLOCK_SIZE,
) -> bytes:
    """Read a .dat byte span back out of local shard files via the
    interval math — the single-host degraded-read building block."""
    out = bytearray()
    handles: dict[int, object] = {}
    try:
        for iv in locate.locate_data(
            large_block_size, small_block_size, dat_size, offset, size
        ):
            shard_id, shard_off = iv.to_shard_id_and_offset(
                large_block_size, small_block_size
            )
            f = handles.get(shard_id)
            if f is None:
                f = handles[shard_id] = open(base_file_name + to_ext(shard_id), "rb")
            f.seek(shard_off)
            chunk = f.read(iv.size)
            if len(chunk) < iv.size:
                chunk += bytes(iv.size - len(chunk))
            out += chunk
    finally:
        for f in handles.values():
            f.close()
    return bytes(out)
