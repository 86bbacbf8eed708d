"""Volume: one append-only .dat + .idx pair and its life cycle.

Behavioral match of reference weed/storage/volume.go +
volume_read_write.go + volume_loading.go + volume_checking.go:

  * creation writes an 8-byte superblock (version, replica placement,
    TTL, compaction revision);
  * writes append a needle record, update the needle map, and append an
    .idx entry; duplicate identical writes are no-ops (isFileUnchanged);
    a write to an existing id must present the same cookie;
  * deletes append a tombstone needle (empty data, fresh AppendAtNs)
    and a tombstone .idx entry pointing at it;
  * reads check not-found / tombstone / TTL expiry and verify CRC;
  * loading replays the .idx and validates its tail against the .dat
    (CheckVolumeDataIntegrity);
  * vacuum/compaction copies live needles to <name>.cpd/.cpx scratch
    files and atomically swaps them in, bumping the superblock
    compaction revision (volume_vacuum.go).

File naming (volume.go FileName): <dir>/<collection>_<vid> or
<dir>/<vid> when the collection is empty.

The port of seaweedfs_tpu/storage/volume.py. Records are serialized in
one call of the C record codec (Needle.encode_record, csrc/needle_ext.c).
"""

from __future__ import annotations

import os
import threading
import time
from typing import Optional

from seaweedfs_tpu_torch.storage import types as t
from seaweedfs_tpu_torch.storage.needle import (
    CorruptNeedle,
    Needle,
    get_actual_size,
)
from seaweedfs_tpu_torch.storage.needle_map import CompactNeedleMap, NeedleValue
from seaweedfs_tpu_torch.storage.replica_placement import ReplicaPlacement
from seaweedfs_tpu_torch.storage.super_block import CURRENT_VERSION, SuperBlock
from seaweedfs_tpu_torch.storage.ttl import TTL
from seaweedfs_tpu_torch.util import durable, wlog

# Invalidates the C serving loop's plan cache (fd/offset/headers keyed
# by path) on any mutation; util.native_serve imports only os/socket/
# threading at top level, so there is no import cycle.
from seaweedfs_tpu_torch.util.native_serve import (
    bump_generation as _serve_cache_bump,
)


class NeedleNotFound(KeyError):
    pass


class VolumeReadOnly(RuntimeError):
    pass


class CookieMismatch(ValueError):
    pass


def volume_base_name(directory: str, collection: str, vid: int) -> str:
    if collection:
        return os.path.join(directory, f"{collection}_{vid}")
    return os.path.join(directory, str(vid))


class _FileLikeOverBackend:
    """File-object protocol (seek/read/tell) over a BackendStorageFile,
    so the Volume read path works unchanged on remote-tier volumes.
    Writes raise: tiered volumes are sealed."""

    def __init__(self, bsf):
        self._bsf = bsf
        self._pos = 0

    def seek(self, offset: int, whence: int = os.SEEK_SET) -> int:
        if whence == os.SEEK_END:
            size, _ = self._bsf.get_stat()
            self._pos = size + offset
        elif whence == os.SEEK_CUR:
            self._pos += offset
        else:
            self._pos = offset
        return self._pos

    def tell(self) -> int:
        return self._pos

    def read(self, n: int = -1) -> bytes:
        if n < 0:
            size, _ = self._bsf.get_stat()
            n = max(0, size - self._pos)
        if n == 0:
            return b""
        data = self._bsf.read_at(n, self._pos)
        self._pos += len(data)
        return data

    def pread(self, n: int, offset: int) -> bytes:
        """Positional read: no shared position, so callers need no lock."""
        return self._bsf.read_at(n, offset)

    def write(self, data: bytes) -> int:
        raise VolumeReadOnly("remote-tier volume is sealed")

    def truncate(self, size: int) -> None:
        raise VolumeReadOnly("remote-tier volume is sealed")

    def flush(self) -> None:
        pass

    def close(self) -> None:
        self._bsf.close()


class Volume:
    def __init__(
        self,
        directory: str,
        vid: int,
        collection: str = "",
        replica_placement: ReplicaPlacement | None = None,
        ttl: TTL | None = None,
        version: int = CURRENT_VERSION,
        create: bool = True,
        needle_map_kind: str = "memory",
        repair: bool = False,
    ):
        self.id = vid
        self.collection = collection
        self.dir = directory
        self.base_name = volume_base_name(directory, collection, vid)
        self.read_only = False
        self.last_append_at_ns = 0
        self._lock = threading.RLock()
        # "memory" (CompactNeedleMap) or "db" (persistent sqlite map —
        # the reference's -index=leveldb variant, needle_map_leveldb.go)
        self.needle_map_kind = needle_map_kind
        # `repair` = crash recovery is allowed to REWRITE the files:
        # roll a half-committed vacuum swap forward/back (.cpm marker)
        # and heal the .idx/.dat tails (truncate torn entries/records,
        # re-index durable .dat records whose idx entries were lost).
        # ONLY the exclusive owner may pass it (DiskLocation at server
        # startup): a -workers follower opening a LIVE volume would
        # otherwise "heal away" the entry the writer is appending
        # right now. docs/ANALYSIS.md v3 has the crash-state model.
        if repair:
            self._recover_compaction()

        dat_path = self.base_name + ".dat"
        # tier metadata: a .vif with remote files means the sealed .dat
        # lives in a remote backend (volume_info.go MaybeLoadVolumeInfo)
        from seaweedfs_tpu_torch.storage import volume_info as vif

        self.volume_info, has_remote = vif.maybe_load_volume_info(
            self.base_name + ".vif"
        )
        exists = os.path.exists(dat_path)
        if has_remote and not exists:
            self._open_remote_dat()
            self.read_only = True
            self.super_block = SuperBlock.read_from(self._dat)
            self.nm = self._load_needle_map()
            self._followed = self.nm.index_file_size()
            return
        if has_remote:
            # keep_local_dat_file case: a local copy exists alongside
            # the remote one — it must stay sealed or the copies diverge
            self.read_only = True
        if not exists:
            if not create:
                raise FileNotFoundError(dat_path)
            self.super_block = SuperBlock(
                version=version,
                replica_placement=replica_placement or ReplicaPlacement(),
                ttl=ttl or TTL(),
            )
            with open(dat_path, "wb") as f:
                f.write(self.super_block.to_bytes())
        self._dat = open(dat_path, "r+b")
        self._bind_fd()
        if exists:
            self.super_block = SuperBlock.read_from(self._dat)
        if repair and exists and not self.read_only:
            self._repair_tail()
            self._bind_fd()  # the heal may have truncated the .dat
        self.nm = self._load_needle_map()
        # how much of the on-disk .idx this process's map reflects —
        # refresh_from_idx replays from here when ANOTHER process is
        # the volume's writer (-shardWrites followers/handback)
        self._followed = self.nm.index_file_size()
        if exists:
            self._check_integrity()

    def _load_needle_map(self):
        if self.needle_map_kind == "db":
            from seaweedfs_tpu_torch.storage.needle_map import DbNeedleMap

            return DbNeedleMap.load(self.base_name + ".idx")
        return CompactNeedleMap.load(self.base_name + ".idx")

    # --- remote tier (backend.go + volume_grpc_tier_*.go) ---
    def _open_remote_dat(self) -> None:
        from seaweedfs_tpu_torch.storage import backend as bk

        bk.ensure_builtin_factories()
        rf = self.volume_info.files[0]
        storage = bk.get_backend(rf.backend_name)
        if storage is None:
            raise RuntimeError(
                f"volume {self.id}: remote backend {rf.backend_name!r} is "
                f"not configured (storage.backend config)"
            )
        self._dat = _FileLikeOverBackend(
            storage.new_storage_file(rf.key, rf.file_size)
        )
        self._fd = None

    def has_remote_file(self) -> bool:
        return self.volume_info.has_remote_file()

    def tier_upload(
        self, backend_name: str, keep_local: bool = False, progress=None
    ) -> tuple[str, int]:
        """Move this (sealed) volume's .dat to a remote backend
        (VolumeTierMoveDatToRemote, volume_grpc_tier_upload.go:14)."""
        from seaweedfs_tpu_torch.storage import backend as bk
        from seaweedfs_tpu_torch.storage import volume_info as vif

        bk.ensure_builtin_factories()
        storage = bk.get_backend(backend_name)
        if storage is None:
            raise RuntimeError(
                f"destination {backend_name!r} not found; configured: "
                f"{sorted(bk.BACKEND_STORAGES)}"
            )
        for rf in self.volume_info.files:
            if rf.backend_name == storage.name:
                raise RuntimeError(f"destination {backend_name} already exists")
        with self._lock:
            was_read_only = self.read_only
            self.read_only = True
            self._dat.flush()
            dat_path = self.base_name + ".dat"
            attributes = {
                "volumeId": str(self.id),
                "collection": self.collection,
                "ext": ".dat",
            }
            try:
                key, size = storage.copy_file(dat_path, attributes, progress)
            except Exception:
                # failed upload must not leave the volume wedged
                # rejecting writes with no .vif written
                self.read_only = was_read_only
                raise
            self.volume_info.files.append(
                vif.RemoteFile(
                    backend_type=storage.storage_type,
                    backend_id=storage.id,
                    key=key,
                    file_size=size,
                    modified_time=int(time.time()),
                    extension=".dat",
                )
            )
            vif.save_volume_info(self.base_name + ".vif", self.volume_info)
            if not keep_local:
                self._dat.close()
                os.remove(dat_path)
                self._open_remote_dat()
            return key, size

    def tier_download(self, keep_remote: bool = False, progress=None) -> int:
        """Bring a tiered volume's .dat back to local disk
        (VolumeTierMoveDatFromRemote, volume_grpc_tier_download.go)."""
        from seaweedfs_tpu_torch.storage import backend as bk
        from seaweedfs_tpu_torch.storage import volume_info as vif

        if not self.volume_info.has_remote_file():
            raise RuntimeError(f"volume {self.id} has no remote file")
        bk.ensure_builtin_factories()
        rf = self.volume_info.files[0]
        storage = bk.get_backend(rf.backend_name)
        if storage is None:
            raise RuntimeError(f"backend {rf.backend_name!r} not configured")
        with self._lock:
            dat_path = self.base_name + ".dat"
            size = storage.download_file(dat_path, rf.key, progress)
            self._dat.close()
            self._dat = open(dat_path, "r+b")
            self._bind_fd()
            if not keep_remote:
                storage.delete_file(rf.key)
                self.volume_info.files.remove(rf)
            if self.volume_info.has_remote_file():
                vif.save_volume_info(self.base_name + ".vif", self.volume_info)
            else:
                self.volume_info.files.clear()
                try:
                    os.remove(self.base_name + ".vif")
                except FileNotFoundError:
                    pass
            self.read_only = False
            return size

    # --- properties ---
    @property
    def version(self) -> int:
        return self.super_block.version

    @property
    def ttl(self) -> TTL:
        return self.super_block.ttl

    def data_file_size(self) -> int:
        self._dat.seek(0, os.SEEK_END)
        return self._dat.tell()

    def content_size(self) -> int:
        return self.nm.content_size()

    def deleted_size(self) -> int:
        return self.nm.deleted_size()

    def file_count(self) -> int:
        return self.nm.file_count

    def deleted_count(self) -> int:
        return self.nm.deletion_count

    def max_file_key(self) -> int:
        return self.nm.max_file_key

    def stats_snapshot(self) -> dict:
        """Consistent stat row for the heartbeat, under the volume
        lock: commit_compact swaps .dat/.idx and the needle map while
        holding self._lock, and an unlocked data_file_size() there
        seeks a CLOSED file — callers must never sample these fields
        without the lock, and this method is the supported way to get
        them from outside the class."""
        with self._lock:
            return {
                "size": self.data_file_size(),
                "file_count": self.file_count(),
                "delete_count": self.deleted_count(),
                "deleted_byte_count": self.deleted_size(),
                "read_only": self.read_only,
            }

    def garbage_level(self) -> float:
        """Fraction of the .dat occupied by deleted records
        (volume_vacuum.go garbageLevel)."""
        size = self.data_file_size()
        if size == 0:
            return 0.0
        return self.nm.deleted_size() / size

    # --- integrity (volume_checking.go:14) ---
    def _check_integrity(self) -> None:
        idx_size = self.nm.index_file_size()
        if idx_size == 0:
            return
        with open(self.base_name + ".idx", "rb") as f:
            f.seek(idx_size - t.NEEDLE_MAP_ENTRY_SIZE)
            from seaweedfs_tpu_torch.storage import idx as idx_codec

            key, offset, size = idx_codec.unpack_entry(f.read(t.NEEDLE_MAP_ENTRY_SIZE))
        if offset == 0:
            return
        if size == t.TOMBSTONE_FILE_SIZE:
            size = 0  # the tombstone .dat record is an empty-data needle
        actual = t.units_to_offset(offset)
        record_end = actual + get_actual_size(size, self.version)
        if record_end > self.data_file_size():
            raise CorruptNeedle(
                f"volume {self.id}: last index entry [key {key}] ends at "
                f"{record_end} past .dat size {self.data_file_size()}"
            )
        # recover lastAppendAtNs from the last record (v3)
        blob = self._read_at(actual, get_actual_size(size, self.version))
        try:
            n = Needle.from_bytes(blob, self.version, size=size)
            self.last_append_at_ns = n.append_at_ns
        except CorruptNeedle:
            raise

    # --- crash recovery (docs/ANALYSIS.md v3) ---
    def _recover_compaction(self) -> None:
        """Resolve a crash that interrupted commit_compact's two-rename
        swap. The `.cpm` marker is the commit point: it is written (and
        made durable, after the scratch bytes were) BEFORE either
        rename, and removed after both — so at recovery,

          marker present  →  the new generation is complete on disk
                             under .cpd/.cpx or already partly swapped
                             in: roll the swap FORWARD (both renames
                             are idempotent re-runs);
          marker absent   →  the commit point was never reached: the
                             old generation is authoritative, stale
                             scratch files are deleted (roll BACK).

        Either way the recovered volume is wholly old or wholly new —
        never the new .dat under the old .idx that a bare two-rename
        sequence can leave behind."""
        marker = self.base_name + ".cpm"
        cpd = self.base_name + ".cpd"
        cpx = self.base_name + ".cpx"
        if os.path.exists(marker):
            # the marker outliving the swap means the db needle map's
            # sqlite table may still index the OLD idx (its clean
            # checkpoint can coincidentally match the new idx size, so
            # load would skip the rebuild): drop it in EVERY
            # marker-present state, not just the cpx-pending one —
            # commit_compact removes the sdb before the marker, so a
            # crash between renames and that removal lands here with
            # cpd/cpx already gone
            sdb = self.base_name + ".idx.sdb"
            if os.path.exists(sdb):
                os.remove(sdb)
            if os.path.exists(cpx):
                wlog.warning(
                    "volume %d: rolling interrupted vacuum commit "
                    "forward from scratch files", self.id,
                )
                if os.path.exists(cpd):
                    os.replace(cpd, self.base_name + ".dat")
                os.replace(cpx, self.base_name + ".idx")
            elif os.path.exists(cpd):
                # cannot happen under the commit order (cpd is renamed
                # first), but never leave a scratch .dat to trip the
                # next compact
                os.remove(cpd)
            os.remove(marker)
            durable.fsync_dir(self.dir)
            return
        removed = False
        for p in (cpd, cpx):
            if os.path.exists(p):
                os.remove(p)
                removed = True
        if removed:
            wlog.warning(
                "volume %d: removed uncommitted compaction scratch "
                "files (crash before the commit point)", self.id,
            )
            durable.fsync_dir(self.dir)

    def _repair_tail(self) -> None:
        """Heal the .idx/.dat tails after an unclean shutdown so the
        recovery invariants hold (docs/ANALYSIS.md v3):

          * the .idx never references bytes past (or torn inside) the
            .dat: trailing entries that fail the bounds or CRC gate are
            truncated away, torn (non-16-multiple) tails first;
          * no acked needle is lost: the .dat is fsynced before a write
            is acked but its .idx entries are not — records past the
            idx-covered region are re-indexed from the .dat (the `weed
            fix` role, run incrementally at load);
          * no torn record surfaces as valid: the tail scan stops at
            the first record that fails the CRC gate and truncates the
            .dat there (those bytes were never acked: the ack's fsync
            would have made them whole).

        A .dat record with EMPTY data re-indexes as a tombstone — the
        scan convention of scan_volume_file and the reference's `weed
        fix`; a zero-byte PUT overwritten by this is the known
        ambiguity (idx entries, which disambiguate, were lost)."""
        idx_path = self.base_name + ".idx"
        try:
            idx_size = os.path.getsize(idx_path)
        except OSError:
            idx_size = 0
        entry = t.NEEDLE_MAP_ENTRY_SIZE
        dat_size = self.data_file_size()
        from seaweedfs_tpu_torch.storage import idx as idx_codec

        usable = idx_size - idx_size % entry
        covered_end = self.super_block.block_size()
        if usable:
            with open(idx_path, "rb") as f:
                while usable >= entry:
                    f.seek(usable - entry)
                    key, offset, size = idx_codec.unpack_entry(
                        f.read(entry)
                    )
                    if offset == 0:
                        # record-less tombstone entry (compaction diff
                        # shape): self-contained, nothing to validate —
                        # but it also does not advance coverage
                        usable_probe = usable - entry
                        covered = self._entry_end_if_valid(
                            f, usable_probe, entry
                        )
                        covered_end = max(covered_end, covered)
                        break
                    norm = 0 if size == t.TOMBSTONE_FILE_SIZE else size
                    end = t.units_to_offset(offset) + get_actual_size(
                        norm, self.version
                    )
                    if end <= dat_size:
                        blob = self._read_at(
                            t.units_to_offset(offset),
                            get_actual_size(norm, self.version),
                        )
                        try:
                            Needle.from_bytes(
                                blob, self.version, size=norm
                            )
                            covered_end = max(covered_end, end)
                            break
                        except (CorruptNeedle, ValueError):
                            pass
                    usable -= entry
        if usable < idx_size:
            wlog.warning(
                "volume %d: truncating .idx tail %d -> %d bytes "
                "(entries referencing torn/missing .dat records)",
                self.id, idx_size, usable,
            )
            os.truncate(idx_path, usable)
            durable.fsync_path(idx_path)
        # --- re-index durable .dat records the idx lost -------------
        scan = covered_end
        regen: list[bytes] = []
        while scan + t.NEEDLE_HEADER_SIZE <= dat_size:
            header = self._read_at(scan, t.NEEDLE_HEADER_SIZE)
            cookie, nid, nsize = Needle.parse_header(header)
            if cookie == 0 and nid == 0 and nsize == 0:
                break  # zero fill: a write hole / preallocation, not data
            rec_len = get_actual_size(nsize, self.version)
            if scan + rec_len > dat_size:
                break  # torn tail record
            blob = self._read_at(scan, rec_len)
            try:
                n = Needle.from_bytes(blob, self.version, size=nsize)
            except (CorruptNeedle, ValueError):
                break  # CRC gate: torn write that landed partially
            regen.append(
                idx_codec.pack_entry(
                    nid,
                    t.offset_to_units(scan),
                    t.TOMBSTONE_FILE_SIZE if not n.data else nsize,
                )
            )
            self.last_append_at_ns = max(
                self.last_append_at_ns, n.append_at_ns
            )
            scan += rec_len
        if scan < dat_size:
            wlog.warning(
                "volume %d: truncating torn .dat tail %d -> %d bytes",
                self.id, dat_size, scan,
            )
            os.truncate(self.base_name + ".dat", scan)
            durable.fsync_path(self.base_name + ".dat")
        if regen:
            wlog.warning(
                "volume %d: re-indexed %d .dat record(s) whose .idx "
                "entries were lost in the crash", self.id, len(regen),
            )
            with open(idx_path, "ab") as f:
                f.write(b"".join(regen))
                f.flush()
                os.fsync(f.fileno())

    def _entry_end_if_valid(self, f, pos: int, entry: int) -> int:
        """End offset of the record referenced by the last non-
        tombstone entry at/below `pos` (walking back), 0 when none —
        coverage probe for _repair_tail when the tail entry itself is
        a record-less tombstone."""
        from seaweedfs_tpu_torch.storage import idx as idx_codec

        dat_size = self.data_file_size()
        while pos >= entry:
            f.seek(pos - entry)
            key, offset, size = idx_codec.unpack_entry(f.read(entry))
            if offset != 0:
                norm = 0 if size == t.TOMBSTONE_FILE_SIZE else size
                end = t.units_to_offset(offset) + get_actual_size(
                    norm, self.version
                )
                return min(end, dat_size)
            pos -= entry
        return 0

    def _bind_fd(self) -> None:
        """Arm the pread/pwrite fast path on the freshly (re)opened
        .dat: positionless IO needs no seek syscall, no flush, and no
        buffered-layer bookkeeping on the data plane."""
        self._fd = self._dat.fileno()
        self._append_end = os.fstat(self._fd).st_size

    def _read_at(self, offset: int, length: int) -> bytes:
        if self._fd is not None:
            return os.pread(self._fd, length, offset)
        return self._dat.pread(length, offset)

    def _append_blob(self, blob) -> int:
        if self._fd is None:
            self._dat.seek(0, os.SEEK_END)
            offset = self._dat.tell()
            if offset % t.NEEDLE_PADDING_SIZE != 0:
                pad = t.NEEDLE_PADDING_SIZE - offset % t.NEEDLE_PADDING_SIZE
                self._dat.write(bytes(pad))
                offset += pad
            self._dat.write(blob)
            self._dat.flush()
            return offset
        offset = self._append_end
        if offset % t.NEEDLE_PADDING_SIZE != 0:
            # realign, matching the reference's defensive padding
            pad = t.NEEDLE_PADDING_SIZE - offset % t.NEEDLE_PADDING_SIZE
            if os.pwrite(self._fd, bytes(pad), offset) != pad:
                raise OSError(f"volume {self.id}: short pad write at {offset}")
            offset += pad
        # a short write (ENOSPC/RLIMIT) must raise BEFORE the needle map
        # records the offset, else a truncated record is indexed as live
        written = os.pwrite(self._fd, blob, offset)
        if written != len(blob):
            raise OSError(
                f"volume {self.id}: short append at {offset}: "
                f"{written}/{len(blob)} bytes"
            )
        self._append_end = offset + len(blob)
        return offset

    def _now_ns(self) -> int:
        ns = time.time_ns()
        if ns <= self.last_append_at_ns:
            ns = self.last_append_at_ns + 1
        return ns

    # --- write path (volume_read_write.go:66 writeNeedle) ---
    def write_needle(
        self, n: Needle, stages: dict | None = None
    ) -> tuple[int, int, bool]:
        """Returns (offset, size, is_unchanged).

        `stages` (tracing plane) collects "crc" — the single-pass
        record serialization, whose cost is the CRC32-C + body memcpy
        the C hot loop times under the same name — and "pwrite", the
        positioned append. Names match write_path.WRITE_STAGES."""
        with self._lock:
            if self.read_only:
                raise VolumeReadOnly(f"volume {self.id} is read-only")
            if self._is_file_unchanged(n):
                return 0, n.size, True
            if n.ttl is None and self.ttl.count != 0:
                n.set_has_ttl()
                n.ttl = self.ttl

            existing = self.nm.get(n.Id if hasattr(n, "Id") else n.id)
            if existing is not None and existing.size != t.TOMBSTONE_FILE_SIZE:
                old = self._read_needle_at(existing)
                if old is not None and old.cookie != n.cookie:
                    raise CookieMismatch(
                        f"mismatching cookie {n.cookie:08x} for needle {n.id}"
                    )

            n.append_at_ns = self._now_ns()
            if stages is None:
                blob = n.encode_record(self.version)
                offset = self._append_blob(blob)
            else:
                import time as _time

                t0 = _time.perf_counter()
                blob = n.encode_record(self.version)
                t1 = _time.perf_counter()
                offset = self._append_blob(blob)
                stages["crc"] = t1 - t0
                stages["pwrite"] = _time.perf_counter() - t1
            self.last_append_at_ns = n.append_at_ns

            if existing is None or existing.actual_offset < offset:
                self.nm.put(n.id, t.offset_to_units(offset), n.size)
            # after the record and map entry are visible: a plan stamped
            # with the pre-bump generation can no longer be inserted
            _serve_cache_bump()
            return offset, n.size, False

    def commit(self) -> None:
        """One durability flush of the .dat (fsync on the pread/pwrite
        fast path). The QoS write path calls this per POST when
        `-commitFsync` is set, or once per group-commit window — the
        weed_commit_flush_total counter is what the fsyncs-per-POST
        bench ratio reads (docs/QOS.md)."""
        with self._lock:
            self._flush_locked()

    def _flush_locked(self) -> None:
        from seaweedfs_tpu_torch.stats.metrics import COMMIT_FLUSHES

        if self._fd is not None:
            os.fsync(self._fd)
        else:
            self._dat.flush()
        COMMIT_FLUSHES.inc()

    def write_needles(
        self,
        entries: list[tuple[Needle, dict | None]],
        durable: bool = False,
    ) -> list:
        """Group commit (docs/QOS.md): the batch counterpart of
        write_needle with identical per-needle semantics — dedup,
        cookie checks, TTL injection, monotonic append_at_ns — but all
        encoded records land with ONE pwritev and at most ONE
        durability flush. Returns one outcome per entry: an
        (offset, size, unchanged) tuple, or the exception instance the
        caller must raise for that needle (per-needle failures must not
        fail batchmates). Byte-identical on disk to the same needles
        written serially through write_needle, by construction: the
        same encode runs at the same offsets in the same order.

        A short pwritev raises for the whole batch BEFORE any needle
        map update — same invariant as the serial path (a truncated
        record must never be indexed as live)."""
        results: list = [None] * len(entries)
        with self._lock:
            if self.read_only:
                raise VolumeReadOnly(f"volume {self.id} is read-only")
            if self._fd is None:
                # buffered (remote-tier shim) volumes have no pwritev
                # fast path; serial appends keep semantics identical
                for i, (n, stages) in enumerate(entries):
                    try:
                        results[i] = self.write_needle(n, stages=stages)
                    except (VolumeReadOnly, CookieMismatch) as e:
                        results[i] = e
                if durable:
                    self._flush_locked()
                return results
            start = self._append_end
            if start % t.NEEDLE_PADDING_SIZE:
                pad = t.NEEDLE_PADDING_SIZE - start % t.NEEDLE_PADDING_SIZE
                if os.pwrite(self._fd, bytes(pad), start) != pad:
                    raise OSError(f"volume {self.id}: short pad write at {start}")
                start += pad
                self._append_end = start
            blobs: list[bytes] = []
            metas: list[tuple[int, Needle, int]] = []  # (entry idx, n, offset)
            cursor = start
            seen_ids: set[int] = set()
            deferred: list[int] = []
            for i, (n, stages) in enumerate(entries):
                if n.id in seen_ids:
                    # a batchmate already writes this id: the serial
                    # path's dedup/cookie checks compare against THAT
                    # record's map entry, which doesn't exist until the
                    # batch commits — defer this entry to a serial
                    # write after the pwritev so the checks see what
                    # they would have seen serially
                    deferred.append(i)
                    continue
                if self._is_file_unchanged(n):
                    results[i] = (0, n.size, True)
                    continue
                if n.ttl is None and self.ttl.count != 0:
                    n.set_has_ttl()
                    n.ttl = self.ttl
                existing = self.nm.get(n.id)
                if existing is not None and existing.size != t.TOMBSTONE_FILE_SIZE:
                    old = self._read_needle_at(existing)
                    if old is not None and old.cookie != n.cookie:
                        results[i] = CookieMismatch(
                            f"mismatching cookie {n.cookie:08x} for needle {n.id}"
                        )
                        continue
                n.append_at_ns = self._now_ns()
                self.last_append_at_ns = n.append_at_ns
                if stages is None:
                    blob = n.encode_record(self.version)
                else:
                    t0 = time.perf_counter()
                    blob = n.encode_record(self.version)
                    stages["crc"] = time.perf_counter() - t0
                blobs.append(blob)
                metas.append((i, n, cursor))
                seen_ids.add(n.id)
                cursor += len(blob)
            if blobs:
                t0 = time.perf_counter()
                written = os.pwritev(self._fd, blobs, start)
                if written != cursor - start:
                    raise OSError(
                        f"volume {self.id}: short batch append at {start}: "
                        f"{written}/{cursor - start} bytes"
                    )
                pwrite_s = time.perf_counter() - t0
                self._append_end = cursor
                for i, n, offset in metas:
                    existing = self.nm.get(n.id)
                    if existing is None or existing.actual_offset < offset:
                        self.nm.put(n.id, t.offset_to_units(offset), n.size)
                    stages = entries[i][1]
                    if stages is not None:
                        # the one syscall serviced the whole batch; each
                        # rider reports the shared wall time
                        stages["pwrite"] = pwrite_s
                    results[i] = (offset, n.size, False)
            for i in deferred:
                # the RLock is already held; these run the exact serial
                # path against the now-committed batch state
                n, stages = entries[i]
                try:
                    results[i] = self.write_needle(n, stages=stages)
                except (VolumeReadOnly, CookieMismatch) as e:
                    results[i] = e
            if durable and blobs:
                self._flush_locked()
            if blobs:
                _serve_cache_bump()  # deferred entries bump via write_needle
        return results

    def _is_file_unchanged(self, n: Needle) -> bool:
        if str(self.ttl):
            return False
        nv = self.nm.get(n.id)
        if nv is None or nv.offset == 0 or nv.size == t.TOMBSTONE_FILE_SIZE:
            return False
        old = self._read_needle_at(nv)
        return (
            old is not None
            and old.cookie == n.cookie
            and old.data == n.data
        )

    def _read_needle_at(self, nv: NeedleValue) -> Optional[Needle]:
        try:
            blob = self._read_at(
                nv.actual_offset, get_actual_size(nv.size, self.version)
            )
            return Needle.from_bytes(blob, self.version, size=nv.size)
        except (CorruptNeedle, ValueError):
            return None

    # --- delete path (volume_read_write.go:115 deleteNeedle) ---
    def delete_needle(self, n: Needle) -> int:
        """Appends a tombstone record; returns the freed byte count."""
        with self._lock:
            if self.read_only:
                raise VolumeReadOnly(f"volume {self.id} is read-only")
            nv = self.nm.get(n.id)
            if nv is None or nv.size == t.TOMBSTONE_FILE_SIZE:
                return 0
            freed = nv.size
            n.data = b""
            n.append_at_ns = self._now_ns()
            blob = n.encode_record(self.version)
            offset = self._append_blob(blob)
            self.last_append_at_ns = n.append_at_ns
            self.nm.delete(n.id, t.offset_to_units(offset))
            _serve_cache_bump()
            return freed

    # --- read path (volume_read_write.go:139 readNeedle) ---
    def read_needle(self, needle_id: int, cookie: int | None = None) -> Needle:
        with self._lock:
            nv = self.nm.get(needle_id)
            if nv is None or nv.offset == 0:
                raise NeedleNotFound(f"needle {needle_id} not found")
            if nv.size == t.TOMBSTONE_FILE_SIZE:
                raise NeedleNotFound(f"needle {needle_id} already deleted")
            span = (nv.actual_offset, get_actual_size(nv.size, self.version))
            remote = self._dat if self._fd is None else None
            if remote is None:
                blob = self._read_at(*span)
        if remote is not None:
            # a remote-tier read is a network round trip: it runs outside
            # the lock, so reads of one tiered volume overlap and nothing
            # that takes the lock (the serving loop's resolver) waits on it
            blob = remote.pread(span[1], span[0])
        n = Needle.from_bytes(blob, self.version, size=nv.size)
        if cookie is not None and n.cookie != cookie:
            raise CookieMismatch(
                f"cookie mismatch for needle {needle_id}"
            )
        if n.has_ttl() and n.ttl is not None and n.ttl.minutes and n.has_last_modified_date():
            expires = n.last_modified + n.ttl.minutes * 60
            if time.time() >= expires:
                raise NeedleNotFound(f"needle {needle_id} expired")
        return n

    def has_needle(self, needle_id: int) -> bool:
        nv = self.nm.get(needle_id)
        return nv is not None and nv.offset != 0 and nv.size != t.TOMBSTONE_FILE_SIZE

    # --- vacuum (volume_vacuum.go) ---
    def compact(self) -> None:
        """Copy live needles to .cpd/.cpx scratch files WITHOUT blocking
        writes (volume_vacuum.go:78-133 Compact2 shape): the lock is
        held only to snapshot the needle map and the current .dat size.
        The .dat is append-only, so every record below the snapshot
        offset is immutable and can be copied lock-free; anything
        appended afterwards (new needles, tombstones, overwrites) is
        replayed by the catch-up diff inside commit_compact
        (makeupDiff, volume_vacuum.go:157)."""
        with self._lock:
            snapshot = list(self.nm.items())
            self._dat.flush()
            self._compact_snapshot_size = self.data_file_size()
            self._compact_snapshot_idx = self.nm.index_file_size()
            sb = self.super_block
        cpd = self.base_name + ".cpd"
        cpx = self.base_name + ".cpx"
        new_sb = SuperBlock(
            version=sb.version,
            replica_placement=sb.replica_placement,
            ttl=sb.ttl,
            compaction_revision=sb.compaction_revision + 1,
            extra=sb.extra,
        )
        snapshot_size = self._compact_snapshot_size
        # the copy runs WITHOUT the volume lock, so it must not touch
        # self._dat: concurrent (locked) writers and readers seek that
        # shared handle, and interleaved seeks would corrupt either the
        # copy or the live file — use a private read-only fd instead
        # (records below the snapshot offset are immutable, append-only)
        with open(cpd, "wb") as dat_out, open(cpx, "wb") as idx_out, open(
            self.base_name + ".dat", "rb"
        ) as dat_in:
            dat_out.write(new_sb.to_bytes())
            from seaweedfs_tpu_torch.storage import idx as idx_codec

            for nv in sorted(snapshot, key=lambda v: v.key):
                if nv.offset == 0 or nv.size == t.TOMBSTONE_FILE_SIZE:
                    continue
                if nv.actual_offset >= snapshot_size:
                    continue  # appended post-snapshot; the diff replays it
                dat_in.seek(nv.actual_offset)
                blob = dat_in.read(get_actual_size(nv.size, self.version))
                new_offset = dat_out.tell()
                dat_out.write(blob)
                idx_out.write(
                    idx_codec.pack_entry(
                        nv.key, t.offset_to_units(new_offset), nv.size
                    )
                )

    def _makeup_diff(self, cpd_path: str, cpx_path: str) -> None:
        """Replay .idx entries appended since the compact snapshot onto
        the scratch files (makeupDiff, volume_vacuum.go:157 — which
        walks the idx tail: the idx distinguishes tombstones from
        legitimate zero-byte needles, where raw .dat records cannot).
        Runs under the volume lock inside commit_compact."""
        from seaweedfs_tpu_torch.storage import idx as idx_codec

        idx_start = getattr(self, "_compact_snapshot_idx", None)
        if idx_start is None:
            # .cpd/.cpx exist but the snapshot boundary is gone (e.g.
            # process restarted between compact and commit): committing
            # would silently drop every post-snapshot write
            raise RuntimeError(
                "compaction scratch files are stale (no snapshot in this "
                "process); run compact again or cleanup_compact"
            )
        idx_path = self.base_name + ".idx"
        with open(idx_path, "rb") as f:
            f.seek(idx_start)
            tail = f.read()
        with open(cpd_path, "r+b") as dat_out, open(cpx_path, "ab") as idx_out:
            dat_out.seek(0, os.SEEK_END)
            for key, offset_units, size in idx_codec.iter_entries(tail):
                if offset_units == 0 or size == t.TOMBSTONE_FILE_SIZE:
                    # append a tombstone RECORD too: the new .dat must
                    # agree with its .idx, or a .dat-scan rebuild
                    # (weed fix / export role) resurrects the needle
                    # (the reference appends a fake delete needle here)
                    tomb = Needle(cookie=0, id=key, data=b"")
                    tomb.append_at_ns = self._now_ns()
                    dat_out.write(tomb.to_bytes(self.version))
                    idx_out.write(
                        idx_codec.pack_entry(key, 0, t.TOMBSTONE_FILE_SIZE)
                    )
                    continue
                blob = self._read_at(
                    t.units_to_offset(offset_units),
                    get_actual_size(size, self.version),
                )
                new_offset = dat_out.tell()
                dat_out.write(blob)
                idx_out.write(
                    idx_codec.pack_entry(
                        key, t.offset_to_units(new_offset), size
                    )
                )
        self._compact_snapshot_idx = None
        self._compact_snapshot_size = None

    def commit_compact(self) -> None:
        """Replay the catch-up diff, then swap .cpd/.cpx in as the live
        files (volume_vacuum.go:157 makeupDiff + commit).

        The swap is TWO renames, so it rides a durable commit-marker
        protocol (the crash enumerator's known suspect — a crash
        between the renames used to leave the new .dat under the old
        .idx, unopenable): scratch bytes are fsynced, then the `.cpm`
        marker is published (THE commit point), then both renames land,
        then the marker is removed. _recover_compaction rolls a crash
        anywhere in that window forward (marker present) or back
        (marker absent); docs/ANALYSIS.md v3 has the state table."""
        with self._lock:
            cpd = self.base_name + ".cpd"
            cpx = self.base_name + ".cpx"
            if not (os.path.exists(cpd) and os.path.exists(cpx)):
                raise FileNotFoundError("no compaction scratch files to commit")
            self._makeup_diff(cpd, cpx)
            # rename-visible-before-data guard: the new generation's
            # BYTES must be durable before any rename can publish them
            durable.fsync_path(cpd)
            durable.fsync_path(cpx)
            marker = self.base_name + ".cpm"
            with open(marker, "wb") as mf:
                mf.write(b"commit\n")
                mf.flush()
                os.fsync(mf.fileno())
            durable.fsync_dir(self.dir)  # commit point: marker durable
            self._dat.close()
            self.nm.close()
            os.replace(cpd, self.base_name + ".dat")
            os.replace(cpx, self.base_name + ".idx")
            durable.fsync_dir(self.dir)  # both renames durable
            # the db needle map's sqlite table indexes the OLD idx —
            # and nm.close() above checkpointed it CLEAN with the old
            # watermark, which can coincidentally equal the compacted
            # idx size, so load would skip the rebuild and serve
            # pre-compaction offsets against the swapped .dat. Remove
            # it INSIDE the marker window: every crash state then
            # either keeps the marker (recovery deletes the table) or
            # has already lost the table here.
            sdb = self.base_name + ".idx.sdb"
            if os.path.exists(sdb):
                os.remove(sdb)
            os.remove(marker)
            durable.fsync_dir(self.dir)
            self._dat = open(self.base_name + ".dat", "r+b")
            self._bind_fd()
            self.super_block = SuperBlock.read_from(self._dat)
            # rebuild the map from the fresh index (the stale sqlite
            # table was removed inside the marker window above)
            self.nm = self._load_needle_map()
            self._followed = self.nm.index_file_size()
            # the fd-swap is THE plan-cache hazard: any cached
            # (fd, offset) pair now points into the pre-compaction file
            _serve_cache_bump()

    def refresh_from_idx(self) -> None:
        """Catch this process's map (and append offset) up with .idx
        entries appended by ANOTHER process — the write-sharding
        follower/handback path (`volume -workers N -shardWrites`): the
        lead calls this for worker-owned volumes before reads and
        heartbeats, and once at ownership handback before any
        file-rewriting admin op (compaction snapshots the IN-MEMORY
        map, so a stale map there would silently drop every entry the
        owner appended — index_file_size() is fstat-based and cannot
        catch it). Only whole 16-byte entries are replayed: a stat
        racing the owner's append may see a torn tail entry."""
        with self._lock:
            try:
                size = os.path.getsize(self.base_name + ".idx")
            except OSError:
                return
            pos = self._followed
            if size <= pos:
                return
            with open(self.base_name + ".idx", "rb") as f:
                f.seek(pos)
                tail = f.read(size - pos)
            from seaweedfs_tpu_torch.storage import idx as idx_codec

            usable = len(tail) - (len(tail) % 16)
            for key, offset, entry_size in idx_codec.iter_entries(tail[:usable]):
                self.nm._replay(key, offset, entry_size)
            self._followed = pos + usable
            if usable:
                _serve_cache_bump()
            # the other process also grew the .dat: re-arm the pwrite
            # append cursor so a post-handback write lands at the tail
            # instead of overwriting the owner's records
            self._append_end = os.fstat(self._fd).st_size

    def cleanup_compact(self) -> None:
        # under the volume lock: the snapshot markers are written by
        # compact()/commit_compact() under it, and an abort racing a
        # late commit must not clear the boundary mid-makeup-diff
        # (the reference lint's unguarded-write finding)
        with self._lock:
            self._compact_snapshot_idx = None
            self._compact_snapshot_size = None
            # .cpm too: an abort must never leave a commit marker that
            # a later restart would "roll forward" over fresh data
            for ext in (".cpd", ".cpx", ".cpm"):
                path = self.base_name + ext
                if os.path.exists(path):
                    os.remove(path)

    # --- lifecycle ---
    def close(self) -> None:
        with self._lock:
            self.nm.close()
            self._dat.close()
            _serve_cache_bump()  # unmount: cached fds are now stale

    def destroy(self) -> None:
        with self._lock:
            self.close()
            for ext in (".dat", ".idx", ".cpd", ".cpx", ".cpm"):
                path = self.base_name + ext
                if os.path.exists(path):
                    os.remove(path)


def scan_volume_file(dat_path: str):
    """Walk every record in a .dat sequentially, yielding
    (needle, byte_offset). Deletion tombstones appear as needles with
    size == 0 (the record delete_needle appends). The scanner role of
    the reference's storage.ScanVolumeFile used by `weed fix`/`export`."""
    with open(dat_path, "rb") as f:
        sb = SuperBlock.read_from(f)
        version = sb.version
        offset = sb.block_size()
        f.seek(offset)
        while True:
            header = f.read(t.NEEDLE_HEADER_SIZE)
            if len(header) < t.NEEDLE_HEADER_SIZE:
                return
            _, _, size = Needle.parse_header(header)
            rest_len = get_actual_size(size, version) - t.NEEDLE_HEADER_SIZE
            rest = f.read(rest_len)
            if len(rest) < rest_len:
                return  # torn tail record
            yield Needle.from_bytes(header + rest, version), offset
            offset += t.NEEDLE_HEADER_SIZE + rest_len
