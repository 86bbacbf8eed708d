"""EcVolume: a mounted set of local EC shards serving needle reads — the
port of seaweedfs_tpu/ec/ec_volume.py, decoding lost intervals on the
card.

Behavioral match of reference weed/storage/erasure_coding/ec_volume.go,
ec_shard.go, ec_volume_delete.go and the local parts of store_ec.go:

  * shards are .ec00-.ec13 files mounted individually (a node usually
    holds a few of the 14);
  * needle lookup binary-searches the sorted .ecx and maps the .dat
    span to per-shard intervals via the striping math (locate.py);
  * reads serve each interval from a local shard when present, else
    reconstruct that interval from any 10 available shards (local
    survivors first, then a first-k-wins race over the `fetch` seam);
  * deletes tombstone the .ecx entry in place and append the needle id
    to the .ecj journal (DeleteNeedleFromEcx).

The decode is `rs._apply` of the volume's codec: on the default cuda
backend that is codec_cuda.cuda_apply_matrix, K1 on `device` (None: the
card; "cpu" runs K1's plain version, only when asked). Decoded tiles
are cached (tile_cache), decoded once under concurrency (singleflight)
and donated to a rebuild of the same shards (repair_session). There is
no fallback to another backend: a K1 that fails to build or launch
fails the read.

The remote tier (the `.evf` sidecar of a volume tiered to an object
store) needs the storage backends, which the port does not have yet:
`load` refuses a volume that carries one rather than serve it as if
its tiered shards were lost.
"""

from __future__ import annotations

import os
import threading
import time
from typing import Callable, Optional

import numpy as np

from seaweedfs_tpu_torch import trace
from seaweedfs_tpu_torch.ec import ec_files, locate, repair_session
from seaweedfs_tpu_torch.ec.codec import ReedSolomon, new_encoder
from seaweedfs_tpu_torch.ec.tile_cache import TileCache
from seaweedfs_tpu_torch.qos.singleflight import SingleFlight
from seaweedfs_tpu_torch.storage import idx as idx_codec
from seaweedfs_tpu_torch.storage import types as t
from seaweedfs_tpu_torch.storage.needle import Needle, get_actual_size
from seaweedfs_tpu_torch.storage.needle_map import SortedNeedleMap
from seaweedfs_tpu_torch.storage.volume import NeedleNotFound, volume_base_name
from seaweedfs_tpu_torch.util import durable, wlog

# fetch(shard_id, offset, size) -> bytes | None. Returning None means
# the shard is unavailable everywhere (candidates exhausted).
ShardFetcher = Callable[[int, int, int], Optional[bytes]]

# staging cap for a tile-batched degraded decode: one leader decodes at
# most this many contiguous cold tiles in one gather + dispatch (32 x
# the 256 KiB default tile = 8 MiB of survivor staging per run, one K1
# launch of [1 x 10] rows over [10, 2097152] lanes)
_DECODE_RUN_TILES = 32


class NotEnoughShards(RuntimeError):
    pass


class ShardTruncated(RuntimeError):
    """A local shard file is shorter than its nominal length (disk
    truncation/corruption). Reads treat the shard as lost and
    reconstruct from the survivors instead of serving zero-fill."""


class EcVolumeShard:
    """One local .ec?? file (ec_shard.go:15)."""

    def __init__(self, directory: str, vid: int, shard_id: int, collection: str = ""):
        self.volume_id = vid
        self.shard_id = shard_id
        self.collection = collection
        self.path = volume_base_name(directory, collection, vid) + ec_files.to_ext(
            shard_id
        )
        self._f = open(self.path, "rb")
        self.size = os.path.getsize(self.path)

    def read_at(self, offset: int, size: int) -> bytes:
        try:
            # pread is positionless: concurrent handler threads share
            # this fd safely (seek+read would interleave positions and
            # misread healthy shards under the ThreadingHTTPServer)
            data = os.pread(self._f.fileno(), size, offset)
        except (OSError, ValueError):
            # fd closed by a concurrent quarantine/unmount — from this
            # reader's view the shard is gone; treat it as lost so the
            # caller falls through to remote fetch / reconstruction
            raise ShardTruncated(
                f"shard {self.shard_id} of vid {self.volume_id}: "
                f"closed during read [{offset}, {offset + size})"
            ) from None
        if len(data) < size:
            # encode materializes zero padding on disk, so every shard
            # file spans the full nominal length — a short read means
            # the file was truncated/corrupted, never legitimate tail
            try:
                on_disk = os.path.getsize(self.path)
            except OSError:
                on_disk = -1  # renamed away by a racing quarantine
            raise ShardTruncated(
                f"shard {self.shard_id} of vid {self.volume_id}: "
                f"read [{offset}, {offset + size}) past file end "
                f"({on_disk} bytes)"
            )
        return data

    def close(self) -> None:
        self._f.close()

    def destroy(self) -> None:
        self.close()
        os.remove(self.path)


class EcVolume:
    def __init__(
        self,
        directory: str,
        vid: int,
        collection: str = "",
        backend: str | None = None,
        device=None,
    ):
        self.volume_id = vid
        self.collection = collection
        self.directory = directory
        self.base_name = volume_base_name(directory, collection, vid)
        self.shards: dict[int, EcVolumeShard] = {}
        self._ecx: SortedNeedleMap | None = None
        # codec backend for degraded-read reconstruction (None = process
        # default: cuda unless WEED_EC_CODEC names another) and the
        # device its kernels run on (None = the card)
        self.backend = backend
        self.device = device
        self._rs: ReedSolomon | None = None
        self.version = 3
        # serializes quarantine decisions so only one thread verifies
        # and unmounts a suspect shard
        self._quarantine_lock = threading.Lock()
        # shard id → reason for every shard quarantined on this volume
        self.quarantined: dict[int, str] = {}
        # shard id → consecutive verified-full-size read failures: at 3
        # the shard is a failing medium (EIO) and gets quarantined so
        # repair regenerates it (chaos hardening, see _read_interval).
        # Only double failures that size-verification cleared count, so
        # transient close/remount races never accumulate here.
        self._read_error_strikes: dict[int, int] = {}
        # degraded-read fast path: reconstructed tiles
        # are cached per volume — decode once, serve later degraded
        # GETs from memory (the decode rows for a (survivors, target)
        # pair are cached on the codec itself, rs.decode_rows)
        self.tile_cache = TileCache()
        # singleflight for tile decodes: N concurrent degraded GETs of
        # one hot uncached tile must not fan out N× k-shard gathers
        self._decode_flight = SingleFlight()
        # the remote tier is not ported: no shard is ever remote here
        # (load refuses a volume with a .evf sidecar)
        self.remote = None

    # --- mounting (disk_location_ec.go) ---
    @classmethod
    def load(
        cls,
        directory: str,
        vid: int,
        collection: str = "",
        backend: str | None = None,
        device=None,
    ) -> "EcVolume":
        ev = cls(directory, vid, collection, backend=backend, device=device)
        if os.path.exists(ev.evf_path):
            # a tiered volume's shards live in an object store: serving
            # it without them would fail reads the reference serves
            raise NotImplementedError(
                f"{ev.evf_path}: EC volume {vid} is tiered to a remote "
                f"backend, and the port has no remote tier (storage/backend)"
            )
        if not os.path.exists(ev.base_name + ".ecx"):
            raise FileNotFoundError(ev.base_name + ".ecx")
        for shard_id in range(ec_files.TOTAL_SHARDS):
            path = ev.base_name + ec_files.to_ext(shard_id)
            if os.path.exists(path):
                ev.mount_shard(shard_id)
        return ev

    def mount_shard(self, shard_id: int) -> None:
        if shard_id not in self.shards:
            self.shards[shard_id] = EcVolumeShard(
                self.directory, self.volume_id, shard_id, self.collection
            )
            # a freshly (re)mounted shard file is a repaired one: the
            # rebuild path wrote a new full-length file at this path.
            # The pop takes the quarantine lock: an admin remount racing
            # a scrub thread's quarantine decision must serialize, or
            # the marker for a shard quarantined mid-mount is lost
            with self._quarantine_lock:
                self.quarantined.pop(shard_id, None)
            # a remounted shard is a REPAIRED one: cached tiles were
            # decoded against the pre-repair survivor set — drop them
            self.tile_cache.invalidate()

    def unmount_shard(self, shard_id: int) -> None:
        # deliberately does NOT close the shard's fd: handler threads
        # may hold a reference and be mid-pread — closing here would at
        # best EBADF them and at worst recycle the fd number into an
        # unrelated open() whose bytes pread would then silently serve
        # as shard data. The file object closes when the last reference
        # (this dict's or a reader's local) is dropped.
        self.shards.pop(shard_id, None)

    def shard_ids(self) -> list[int]:
        return sorted(self.shards)

    @property
    def evf_path(self) -> str:
        return self.base_name + ".evf"

    def serving_shard_ids(self) -> list[int]:
        """Shards this node can serve: its local mounts (the reference
        adds tiered remote shards; the port has no remote tier)."""
        return self.shard_ids()

    def _with_remote(self, fetch: ShardFetcher | None) -> ShardFetcher | None:
        """The reference interposes the tier backend ahead of the
        peer-fetch seam here; with no remote tier it is `fetch`."""
        return fetch

    @property
    def rs(self) -> ReedSolomon:
        if self._rs is None:
            self._rs = new_encoder(backend=self.backend, device=self.device)
        return self._rs

    # --- index ---
    def _ecx_map(self) -> SortedNeedleMap:
        if self._ecx is None:
            self._ecx = SortedNeedleMap.load(self.base_name + ".ecx")
        return self._ecx

    def locate_needle(self, needle_id: int) -> tuple[int, int]:
        """(dat offset, stored size) via .ecx binary search; raises
        NeedleNotFound for missing or tombstoned ids."""
        nv = self._ecx_map().search(needle_id)
        if nv is None:
            raise NeedleNotFound(f"needle {needle_id} not in ec volume")
        if nv.size == t.TOMBSTONE_FILE_SIZE:
            raise NeedleNotFound(f"needle {needle_id} deleted")
        return nv.actual_offset, nv.size

    def dat_file_size(self) -> int:
        """Original .dat size derived from the shard size via the
        row-count quirk (shard = nLarge·large + nSmall·small; we only
        need a dat_size that reproduces the same row split).

        Uses the MAX across mounted shards: intact shards all share the
        nominal length, while a truncated one is shorter — deriving
        geometry from it would mis-split rows and corrupt the interval
        mapping for every shard."""
        shard_size = self._nominal_shard_len()
        large, small = locate.LARGE_BLOCK_SIZE, locate.SMALL_BLOCK_SIZE
        n_large = shard_size // large
        n_small = (shard_size - n_large * large) // small
        # any size in the row span maps identically; use the row capacity
        return n_large * large * locate.DATA_SHARDS + n_small * small * locate.DATA_SHARDS

    # --- reads (store_ec.go:119 ReadEcShardNeedle) ---
    def read_needle(
        self, needle_id: int, fetch: ShardFetcher | None = None
    ) -> Needle:
        offset, size = self.locate_needle(needle_id)
        span = get_actual_size(size, self.version)
        blob = self.read_span(offset, span, fetch)
        return Needle.from_bytes(blob, self.version, size=size)

    def read_span(
        self, offset: int, size: int, fetch: ShardFetcher | None = None
    ) -> bytes:
        fetch = self._with_remote(fetch)
        dat_size = self.dat_file_size()
        out = bytearray()
        for iv in locate.locate_data(
            locate.LARGE_BLOCK_SIZE, locate.SMALL_BLOCK_SIZE, dat_size, offset, size
        ):
            shard_id, shard_off = iv.to_shard_id_and_offset()
            out += self._read_interval(shard_id, shard_off, iv.size, fetch)
        return bytes(out)

    def quarantine_shard(self, shard_id: int, reason: str) -> bool:
        """Quarantine a shard this node holds: unmount it (every later
        read treats it as lost — remote fetch first, reconstruction
        fallback) AND rename its file to `<shard>.bad` so the rebuild
        path sees it as MISSING and regenerates it — an unmount alone
        would leave a full-length corrupt file that shard_presence()
        counts as present, silently skipping the regeneration (and a
        restart would remount it). The rename is safe under concurrent
        preads: open fds follow the inode, so in-flight reads of other
        (healthy) interleavings finish normally. Returns True when the
        shard was quarantined by THIS call."""
        with self._quarantine_lock:
            shard = self.shards.get(shard_id)
            if shard is None:
                return False  # not mounted (or already quarantined)
            self.unmount_shard(shard_id)
            try:
                os.replace(shard.path, shard.path + ".bad")
                # dir fsync: the quarantine decision must survive a
                # crash — a resurrected corrupt shard would be remounted
                # at restart and silently skip regeneration (rebuild
                # keys off the shard file being MISSING)
                durable.fsync_dir(self.directory)
            except OSError:
                pass  # vanished/unwritable dir: unmount still protects
            self.quarantined[shard_id] = reason
        self.tile_cache.invalidate()
        return True

    def _quarantine_if_truncated(self, shard_id: int) -> bool:
        """Quarantine a suspect shard only after re-verifying the
        on-disk file really is shorter than its nominal length (a short
        pread can also mean the fd was closed under us, or a racing
        replace). Serialized so concurrent failing readers don't
        double-close. Returns True when the shard is quarantined (or
        already gone)."""
        with self._quarantine_lock:
            shard = self.shards.get(shard_id)
            if shard is None:
                return True  # another thread already quarantined it
            try:
                actual = os.path.getsize(shard.path)
            except OSError:
                actual = -1  # file vanished: certainly not servable
            # nominal length comes from the siblings (every intact shard
            # of a volume shares it — the dat_file_size derivation), not
            # from this shard's own mount-time size: a shard mounted
            # already-truncated would otherwise equal its own "nominal"
            # and never be evicted
            nominal = max(s.size for s in self.shards.values())
            if actual >= nominal:
                return False
            # self-heal beyond the reference: quarantine the corrupt
            # shard so this and every later read treats it exactly like
            # a lost shard, and its short length can never poison
            # dat_file_size()'s geometry
            wlog.warning(
                "ec read: shard %d of vid %d is %d bytes, nominal %d; "
                "quarantining",
                shard_id, self.volume_id, actual, nominal,
            )
            self.unmount_shard(shard_id)
            try:
                os.replace(shard.path, shard.path + ".bad")
                # same dir-fsync contract as quarantine_shard above
                durable.fsync_dir(self.directory)
            except OSError:
                pass
            reason = f"truncated: {actual} bytes, nominal {nominal}"
            self.quarantined[shard_id] = reason
        self.tile_cache.invalidate()
        return True

    def _read_interval(
        self, shard_id: int, offset: int, size: int, fetch: ShardFetcher | None
    ) -> bytes:
        shard = self.shards.get(shard_id)
        if shard is not None:
            data = None
            try:
                data = shard.read_at(offset, size)
            except ShardTruncated as e:
                if not self._quarantine_if_truncated(shard_id):
                    # healthy full-size file: the failure was transient
                    # (racing close+remount, or interleaved replace) —
                    # one retry against the current mount
                    cur = self.shards.get(shard_id)
                    if cur is not None:
                        try:
                            data = cur.read_at(offset, size)
                        except ShardTruncated:
                            # still verify before evicting: a second
                            # transient race must not permanently
                            # quarantine a healthy on-disk shard
                            if not self._quarantine_if_truncated(shard_id):
                                # full-size file that still won't read:
                                # a failing medium (EIO), not a race.
                                # Three CONSECUTIVE strikes quarantine
                                # it so the repair plane regenerates
                                # the shard instead of every future
                                # read paying retry+reconstruct forever
                                # (quarantine, don't crash)
                                strikes = self._read_error_strikes
                                strikes[shard_id] = strikes.get(shard_id, 0) + 1
                                if strikes[shard_id] >= 3:
                                    strikes.pop(shard_id, None)
                                    self.quarantine_shard(
                                        shard_id,
                                        f"persistent read errors: {e}",
                                    )
                if data is None:
                    wlog.warning("ec read: %s; falling back to recovery", e)
            if data is not None:
                # a clean read clears the strike count: the counter
                # tracks CONSECUTIVE failures, so rare transient races
                # spread over weeks can never add up to a quarantine
                # of a healthy shard
                if self._read_error_strikes:
                    self._read_error_strikes.pop(shard_id, None)
                return data
        if self.tile_cache.covers(shard_id, offset, size):
            # a prior degraded read already decoded this range: memory
            # beats even a healthy remote shard fetch
            return self._reconstruct_interval(shard_id, offset, size, fetch)
        if fetch is not None:
            data = fetch(shard_id, offset, size)
            if data is not None:
                return data
        return self._reconstruct_interval(shard_id, offset, size, fetch)

    def _nominal_shard_len(self) -> int:
        """Full per-shard byte length (every intact shard of a volume
        shares it — see dat_file_size)."""
        sizes = [s.size for s in list(self.shards.values())]
        if not sizes:
            raise NotEnoughShards("no local shards mounted")
        return max(sizes)

    def _reconstruct_interval(
        self, target_shard: int, offset: int, size: int, fetch: ShardFetcher | None
    ) -> bytes:
        """Serve a degraded interval, decoding whole cache tiles so the
        k-shard gather runs once per tile instead of once per GET —
        and decoding contiguous RUNS of uncached tiles in ONE
        gather + decode dispatch: a GET spanning M cold tiles used to
        round-trip the survivor gather and the codec M times; now the
        leader stages the whole run's survivor span once, decodes it
        in one dispatch (bytewise RS: a span decode IS the per-tile
        decodes concatenated), and feeds the tile cache in bulk.
        Freshly decoded tiles are donated to an in-progress rebuild of
        the same shard (repair piggyback, repair_session.py)."""
        from seaweedfs_tpu_torch.stats.metrics import EC_DEGRADED_READS

        EC_DEGRADED_READS.inc()
        cache = self.tile_cache
        if not cache.enabled:
            return self._reconstruct_range(target_shard, offset, size, fetch)
        tile = cache.tile_bytes
        try:
            shard_len = self._nominal_shard_len()
        except NotEnoughShards:
            # every local shard vanished under us (concurrent
            # quarantine drained self.shards mid-read): exact-interval
            # reconstruction needs no local geometry — the remote
            # gather can still find k survivors
            return self._reconstruct_range(target_shard, offset, size, fetch)
        sess = repair_session.find(self.volume_id)
        out = bytearray()
        pos = offset
        end = offset + size
        while pos < end:
            t_off = (pos // tile) * tile
            data = cache.get(target_shard, t_off)
            owned: list[tuple[int, threading.Event]] = []
            if data is None:
                # singleflight: exactly one thread decodes a given tile;
                # the rest wait on its event and re-probe the cache —
                # without this, N concurrent GETs of one hot uncached
                # tile fan out N× the k-shard gather and N decodes
                key = (target_shard, t_off)
                lease = self._decode_flight.lead(key)
                if lease is not None:
                    owned.append((t_off, lease))
                else:
                    self._decode_flight.wait(key, timeout=30.0)
                    data = cache.get(target_shard, t_off)
                    # a miss here means the leader failed (or the cache
                    # evicted/invalidated): decode for ourselves below,
                    # WITHOUT re-registering — correctness never depends
                    # on the singleflight, only the stampede width does
            if data is None and not owned:
                t_len = min(tile, shard_len - t_off)
                gen = cache.invalidations
                data = self._reconstruct_range(
                    target_shard, t_off, t_len, fetch
                )
                if cache.put(target_shard, t_off, data, gen=gen) and (
                    sess is not None
                ):
                    sess.donate(target_shard, t_off, data)
            elif data is None:
                # this thread leads tile t_off: extend leadership over
                # the following uncached tiles this interval still
                # needs (stopping at a cache hit, another leader, the
                # shard tail, or the staging cap) — the whole run then
                # costs ONE survivor gather and ONE decode dispatch
                run_lim = min(shard_len, -(-end // tile) * tile)
                nxt = t_off + tile
                while nxt < run_lim and len(owned) < _DECODE_RUN_TILES:
                    if cache.get(target_shard, nxt) is not None:
                        break
                    lease = self._decode_flight.lead((target_shard, nxt))
                    if lease is None:
                        break
                    owned.append((nxt, lease))
                    nxt += tile
                run_len = min(nxt, shard_len) - t_off
                if run_len <= 0:
                    self._release_decode_leases(target_shard, owned)
                    raise NotEnoughShards(
                        f"vid {self.volume_id}: shard {target_shard} "
                        f"interval [{offset}, {end}) past shard length"
                    )
                # capture the invalidation generation BEFORE the gather:
                # a quarantine landing mid-decode may mean a survivor we
                # already read was corrupt — the stale result must not
                # be cached or donated (put() checks gen under the lock
                # invalidate() increments under)
                gen = cache.invalidations
                try:
                    run = self._reconstruct_range(
                        target_shard, t_off, run_len, fetch
                    )
                finally:
                    # wake waiters of every owned tile, win or lose
                    self._release_decode_leases(target_shard, owned)
                for j, (o_off, _) in enumerate(owned):
                    chunk = run[j * tile : min((j + 1) * tile, run_len)]
                    if not chunk:
                        break
                    if cache.put(target_shard, o_off, chunk, gen=gen) and (
                        sess is not None
                    ):
                        # piggyback: this tile is exactly what the
                        # rebuild writer needs at this offset — serving
                        # traffic makes repair forward-progress instead
                        # of duplicating its reads. Gated on the same
                        # gen check as the insert; the residual window
                        # between put and donate is backstopped by the
                        # scrub plane's parity sweep of the rebuilt
                        # shard.
                        sess.donate(target_shard, o_off, chunk)
                take = min(end, t_off + run_len) - pos
                if take <= 0:
                    raise NotEnoughShards(
                        f"vid {self.volume_id}: shard {target_shard} "
                        f"interval [{offset}, {end}) past reconstructed "
                        f"length"
                    )
                out += run[pos - t_off : pos - t_off + take]
                pos += take
                continue
            take = min(end, t_off + len(data)) - pos
            if take <= 0:  # cached tail tile shorter than the request
                raise NotEnoughShards(
                    f"vid {self.volume_id}: shard {target_shard} interval "
                    f"[{offset}, {end}) past reconstructed length"
                )
            out += data[pos - t_off : pos - t_off + take]
            pos += take
        return bytes(out)

    def _release_decode_leases(
        self, target_shard: int, owned: list[tuple[int, "threading.Event"]]
    ) -> None:
        """Unregister this thread's singleflight leases and wake their
        waiters (who re-probe the cache and self-serve on a miss)."""
        for o_off, ev in owned:
            self._decode_flight.release((target_shard, o_off), ev)

    def donate_cached_tiles(self, sess) -> int:
        """Seed a just-opened rebuild session with every resident tile
        of its target shards: degraded traffic that ALREADY ran still
        makes repair forward-progress. Returns tiles donated."""
        donated = 0
        for target in sess.targets:
            for t_off, data in self.tile_cache.snapshot(target):
                if sess.donate(target, t_off, data):
                    donated += 1
        return donated

    def _reconstruct_range(
        self, target_shard: int, offset: int, size: int, fetch: ShardFetcher | None
    ) -> bytes:
        """Rebuild one shard range from any k shards: local survivors
        first, then a first-k-wins race over ALL remote candidates on
        the shared qos.hedge attempt pool (the degraded analogue of
        hedged replica reads: no straggler is waited on). The decode is
        one rs._apply of the cached [1, k] decode rows over the [k,
        size] survivor stack: K1 on the cuda backend. Its "ec.degraded"
        span carries the stages "gather" (survivor reads and the stack)
        and "decode" (rs._apply)."""
        k = self.rs.data_shards
        total = self.rs.total_shards
        sess = repair_session.find(self.volume_id)
        if sess is not None:
            sess.serving_enter()
        try:
            with trace.span(
                "ec.degraded", plane="serve", nbytes=size
            ) as sp:
                t_gather = time.perf_counter()
                shards: list[Optional[np.ndarray]] = [None] * total
                available = 0
                # snapshot: mount/unmount RPCs mutate self.shards
                for sid, local in list(self.shards.items()):
                    if sid == target_shard:
                        continue
                    if available >= k:
                        break  # the decode uses the first k survivors
                    try:
                        shards[sid] = np.frombuffer(
                            local.read_at(offset, size), dtype=np.uint8
                        )
                    except ShardTruncated as e:
                        wlog.warning("ec rebuild: %s", e)
                        self._quarantine_if_truncated(sid)
                        continue  # a corrupt survivor counts as missing
                    available += 1
                if fetch is not None and available < k:
                    candidates = [
                        sid
                        for sid in range(total)
                        if shards[sid] is None and sid != target_shard
                    ]

                    def attempt(done, sid):
                        if done.is_set():
                            return None  # k winners already in
                        data = fetch(sid, offset, size)
                        if data is None or len(data) != size:
                            return None
                        return data

                    from seaweedfs_tpu_torch.qos import hedge

                    got = hedge.gather_first_k(
                        {
                            sid: (lambda done, s=sid: attempt(done, s))
                            for sid in candidates
                        },
                        k - available,
                    )
                    for sid, raw in got.items():
                        shards[sid] = np.frombuffer(raw, dtype=np.uint8)
                        available += 1
                if available < k:
                    raise NotEnoughShards(
                        f"vid {self.volume_id}: only {available} of {k} "
                        f"shards reachable to rebuild shard {target_shard}"
                    )
                survivors = tuple(
                    i for i, s in enumerate(shards) if s is not None
                )[:k]
                # decode rows cached on the codec: inverted once per
                # (survivors, target), not per interval
                rows = self.rs.decode_rows(survivors, (target_shard,))
                stacked = np.stack([shards[i] for i in survivors])
                t_decode = time.perf_counter()
                rebuilt = self.rs._apply(rows, stacked)
                if sp:
                    sp.add_stages({"gather": t_decode - t_gather,
                                   "decode": time.perf_counter() - t_decode})
                    sp.annotate("vid", self.volume_id)
                    sp.annotate("shard", target_shard)
                return rebuilt[0].tobytes()
        finally:
            if sess is not None:
                sess.serving_exit()

    # --- deletes (ec_volume_delete.go) ---
    def delete_needle(self, needle_id: int) -> None:
        """Tombstone the .ecx entry in place + journal to .ecj."""
        m = self._ecx_map()
        i = m.entry_index(needle_id)
        if i < 0:
            return
        if int(m.sizes[i]) == t.TOMBSTONE_FILE_SIZE:
            return
        entry_off = i * idx_codec.ENTRY_SIZE + t.NEEDLE_ID_SIZE + t.OFFSET_SIZE
        with open(self.base_name + ".ecx", "r+b") as f:
            f.seek(entry_off)
            f.write((t.TOMBSTONE_FILE_SIZE).to_bytes(4, "big"))
        m.sizes[i] = t.TOMBSTONE_FILE_SIZE
        with open(self.base_name + ".ecj", "ab") as f:
            f.write(t.needle_id_to_bytes(needle_id))

    # --- lifecycle ---
    def close(self) -> None:
        for shard in self.shards.values():
            shard.close()
        self.shards.clear()

    def destroy(self) -> None:
        self.close()
        for shard_id in range(ec_files.TOTAL_SHARDS):
            p = self.base_name + ec_files.to_ext(shard_id)
            for path in (p, p + ".bad"):  # .bad = quarantined forensic copy
                if os.path.exists(path):
                    os.remove(path)
        for ext in (".ecx", ".ecj"):
            p = self.base_name + ext
            if os.path.exists(p):
                os.remove(p)
