"""SO_REUSEPORT read workers: per-core scaling for the volume data plane.

The port of seaweedfs_tpu/server/volume_workers.py. A worker process
serves from disk and never touches the card: it imports neither torch
nor anything that does, and proxies EC reads — whose decodes run on the
card — to the lead.

The reference volume server scales across cores for free — Go
schedules request goroutines onto every CPU (bazil-style concurrency
behind weed/server/volume_server_handlers_read.go). A CPython process
is pinned to one core by the GIL, so `volume -workers N` spawns N-1
extra *read worker* processes that share the SAME host:port through
SO_REUSEPORT (the kernel distributes accepted connections across the
listeners — the mechanism nginx/envoy use for per-core workers):

  * worker processes serve plain GET/HEAD straight from the shared
    volume directories — each opens the volumes read-only and keeps
    its needle map fresh by replaying the append-only `.idx` tail
    (one fstat per lookup; an inode change means the lead vacuumed
    the volume, which triggers a clean reopen);
  * everything else — writes, deletes, EC/chunk-manifest reads, the
    UI/status pages, image resizing — is proxied over a pooled
    keep-alive connection to the lead's internal listener, so the
    whole surface stays available on every accepted connection;
  * the LEAD (worker 0) remains the one full volume server: it runs
    the gRPC admin plane and sends the heartbeats. Its inventory
    covers the shared directories, so the master sees one data node.
  * with `-shardWrites`, workers additionally OWN the writes for vids
    with vid % N == their index: they append those volumes'
    .dat/.idx themselves (single-writer-per-volume, partitioned
    across processes), fan out replication on first-hop writes, and
    hand ownership back to the lead before any file-rewriting admin
    op (the /__shard/release handshake).

Read-your-writes holds because every writer appends the `.idx` entry
(and flushes it) before replying 201, and readers re-check the idx
size on every lookup miss-or-hit cycle. Vacuum is safe because a
reader keeps serving the old inode until the commit renames land,
then reopens (with retry — the reopen itself can straddle a commit).
"""

from __future__ import annotations

import os
import threading

from seaweedfs_tpu_torch.storage import idx as idx_codec
from seaweedfs_tpu_torch.storage.disk_location import parse_volume_file_name
from seaweedfs_tpu_torch.storage.file_id import FileId
from seaweedfs_tpu_torch.storage.needle import Needle  # noqa: F401 (re-export for tests)
from seaweedfs_tpu_torch.storage.volume import (
    CookieMismatch,
    NeedleNotFound,
    Volume,
)
from seaweedfs_tpu_torch.util import wlog
from seaweedfs_tpu_torch.util.httpd import (
    JSON_HDR,
    FastHandler,
    WeedHTTPServer,
    etag_matches,
    fast_query,
)

_HOP_HEADERS = {
    "connection",
    "keep-alive",
    "transfer-encoding",
    "content-length",
    "host",
    # internal ownership signaling: a client-supplied copy must never
    # ride through the proxy (the lead would seize the vid); _proxy
    # re-adds its own AFTER this filter when the owner declined
    "x-shard-hop",
}


class VolumeReleased(RuntimeError):
    """Raised under the volume lock when a write's vid was handed back
    to the lead after the caller's ownership gate (release/write race:
    the release ack drains this lock, so any append the lead's refresh
    could miss must abort and re-route instead)."""


class SharedReadVolume:
    """A read-only view of a volume whose writer lives in the lead
    process, kept fresh from the on-disk `.idx` (see module docstring)."""

    def __init__(self, directory: str, vid: int, collection: str = ""):
        self.directory = directory
        self.vid = vid
        self.collection = collection
        self._lock = threading.Lock()
        self._open()

    _ENTRY = 16  # NEEDLE_MAP_ENTRY_SIZE
    _OPEN_RETRIES = 40
    _OPEN_RETRY_S = 0.005

    def _open(self) -> None:
        import time as _time

        from seaweedfs_tpu_torch.storage.needle import CorruptNeedle
        from seaweedfs_tpu_torch.storage.volume import volume_base_name

        # stat BEFORE loading: entries appended between the stat and
        # the load replay twice, which is safe (idx replay is last-wins
        # idempotent; metrics are lead-owned). Statting after would
        # skip the [loaded, stat] window forever.
        #
        # The open itself RETRIES: a reopen can straddle a vacuum
        # commit (commit_compact replaces .dat then .idx), catching an
        # inconsistent name pair — e.g. the previous index alongside
        # the next, smaller compacted .dat, which Volume's integrity
        # check rejects (found by TestTornReadUnderVacuum: ~1 in 50
        # tight commits). Each retry re-stats, so the loop converges on
        # the post-commit pair; pinned fds keep already-open volumes
        # safe — only this reopen window needs the loop.
        self._idx_path = (
            volume_base_name(self.directory, self.collection, self.vid) + ".idx"
        )
        for attempt in range(self._OPEN_RETRIES):
            st = os.stat(self._idx_path)
            try:
                vol = Volume(
                    self.directory, self.vid, self.collection, create=False
                )
            except (CorruptNeedle, OSError, ValueError):
                if attempt == self._OPEN_RETRIES - 1:
                    raise
                # weedlint: ignore[hot-loop-sleep] — bounded 40×5 ms vacuum-commit reopen retry; the alternative is failing the read
                _time.sleep(self._OPEN_RETRY_S)
                continue
            # the pair must still be the one we statted: an idx swapped
            # in mid-open would replay with wrong offsets
            st2 = os.stat(self._idx_path)
            if st2.st_ino != st.st_ino:
                vol.close()
                # weedlint: ignore[hot-loop-sleep] — same bounded reopen retry: the idx swapped mid-open, converges within one commit
                _time.sleep(self._OPEN_RETRY_S)
                continue
            self._idx_ino = st.st_ino
            self._replayed = st.st_size - (st.st_size % self._ENTRY)
            self._vol = vol
            return
        raise OSError(f"volume {self.vid}: no consistent .dat/.idx pair")

    def _refresh(self) -> None:
        st = os.stat(self._idx_path)
        if st.st_ino != self._idx_ino:
            # vacuum/compact committed: whole new .dat/.idx pair
            old = self._vol
            self._open()
            old.close()
            return
        if st.st_size > self._replayed:
            with open(self._idx_path, "rb") as f:
                f.seek(self._replayed)
                tail = f.read(st.st_size - self._replayed)
            # whole entries only: a read racing the lead's 16-byte
            # append may end mid-entry, and advancing past those bytes
            # would shift every later decode
            usable = len(tail) - (len(tail) % self._ENTRY)
            for key, offset, size in idx_codec.iter_entries(tail[:usable]):
                self._vol.nm._replay(key, offset, size)
            self._replayed += usable

    def read_needle(self, needle_id: int, cookie: int | None = None) -> Needle:
        from seaweedfs_tpu_torch.storage.needle import CorruptNeedle, CookieMismatch

        with self._lock:
            self._refresh()
        try:
            return self._vol.read_needle(needle_id, cookie=cookie)
        except (CorruptNeedle, CookieMismatch):
            # reopen-and-retry: a reopen that straddled a commit's
            # dat→idx rename window can pair an index with a dat whose
            # offsets moved — the per-needle cookie+CRC catches it
            # here; a fresh consistent pair must agree. A GENUINE bad
            # cookie / corrupt blob fails identically on the retry and
            # the original error propagates.
            with self._lock:
                old = self._vol
                self._open()
                if old is not self._vol:
                    old.close()
            return self._vol.read_needle(needle_id, cookie=cookie)

    # --- -shardWrites owner side -----------------------------------------
    # When this worker OWNS the vid (vid % n_writers == index), the
    # wrapped Volume is the volume's single writer: appends go through
    # the same Volume.write_needle/delete_needle as the lead's (dat
    # pwrite + idx append + flush before the 201 — read-your-writes for
    # every other process's tail replay). _refresh first, so overwrite
    # cookie checks and dedup see anything the lead wrote before
    # ownership started.
    def write_needle(
        self, n: Needle, precheck=None, stages=None
    ) -> tuple[int, bool]:
        with self._lock:
            if precheck is not None and not precheck():
                # ownership was released between the caller's gate and
                # this lock: the write must go to the new owner, not
                # land here after the lead's catch-up refresh
                raise VolumeReleased(self.vid)
            self._refresh()
            _, size, unchanged = self._vol.write_needle(n, stages=stages)
            # own append is already in the map: advance the replay
            # cursor past it or the next _refresh re-replays it and
            # double-counts the map metrics
            self._replayed = self._vol.nm.index_file_size()
            return size, unchanged

    def write_needles(
        self, entries, precheck=None, durable: bool = False
    ) -> list:
        """Batch counterpart of write_needle for the worker-side group
        commit window (qos/group_commit.py): ONE ownership precheck and
        refresh cover the whole batch — the release ack drains this
        lock, so the batch either lands wholly before the handback or
        aborts wholesale and re-routes to the new owner."""
        with self._lock:
            if precheck is not None and not precheck():
                raise VolumeReleased(self.vid)
            self._refresh()
            results = self._vol.write_needles(entries, durable=durable)
            self._replayed = self._vol.nm.index_file_size()
            return results

    def delete_needle(self, n: Needle, precheck=None) -> int:
        with self._lock:
            if precheck is not None and not precheck():
                raise VolumeReleased(self.vid)
            self._refresh()
            size = self._vol.delete_needle(n)
            self._replayed = self._vol.nm.index_file_size()
            return size

    def native_post(
        self, fid, q, body, headers, url_filename, precheck=None,
        stages=None,
    ) -> bytes | None:
        """The C one-pass POST (write_path.try_native_post) under this
        wrapper's refresh + release-precheck discipline. None = take
        the Python slow path (same bytes either way)."""
        from seaweedfs_tpu_torch.server import write_path

        with self._lock:
            if precheck is not None and not precheck():
                raise VolumeReleased(self.vid)
            self._refresh()
            reply = write_path.try_native_post(
                self._vol, fid, q, body, headers, url_filename,
                fix_jpg_orientation=True, stages=stages,
            )
            if reply is not None:
                # own append is already in the map: advance the replay
                # cursor past it (same bookkeeping as write_needle)
                self._replayed = self._vol.nm.index_file_size()
            return reply

    @property
    def volume(self):
        return self._vol

    def close(self) -> None:
        self._vol.close()


class _CommitVolume:
    """The lead-Volume surface qos.group_commit.GroupCommitter expects
    (`.id`, write_needle → (offset, size, unchanged), write_needles,
    commit) over a SharedReadVolume plus its ownership precheck.
    Commit windows key on `.id`, so concurrent owned writes against
    one vid coalesce no matter which request built the facade."""

    __slots__ = ("_srv", "_precheck")

    def __init__(self, srv: SharedReadVolume, precheck):
        self._srv = srv
        self._precheck = precheck

    @property
    def id(self):  # noqa: A003 — mirrors storage.Volume.id
        return self._srv.vid

    def write_needle(self, n, stages=None):
        size, unchanged = self._srv.write_needle(
            n, precheck=self._precheck, stages=stages
        )
        return 0, size, unchanged

    def write_needles(self, entries, durable: bool = False):
        return self._srv.write_needles(
            entries, precheck=self._precheck, durable=durable
        )

    def commit(self):
        self._srv.volume.commit()


class VolumeReadWorker:
    """One worker process: shared-port listener + blob read fast path."""

    def __init__(
        self,
        directories: list[str],
        host: str,
        port: int,
        lead: str,
        worker_port: int = 0,
        shard_writes: bool = False,
        writer_index: int = 0,
        n_writers: int = 1,
        master: str = "",
        internal_port: int = 0,
        guard=None,
        admission_rate: float = 0.0,
        admission_burst: float = 0.0,
        admission_inflight: int = 0,
        admission_procs: int = 1,
        admission_shm_path: str = "",
        commit_window_us: int = 0,
        commit_bytes: int = 4 << 20,
        commit_batch: int = 64,
        commit_fsync: bool = False,
    ):
        self.directories = directories
        self.host = host
        self.port = port
        self.lead = lead  # host:port of the lead's internal listener
        # QoS admission control (docs/QOS.md): with -admissionShmPath
        # every SO_REUSEPORT sibling (lead included) charges ONE
        # mmap'd bucket per client key, so the GLOBAL budget holds no
        # matter how the kernel spreads connections — and the C epoll
        # loop sheds natively. Without it, each member enforces rate/N
        # (exact only under uniform connection spread). Before either,
        # only the lead gated and N-1 of every N connections bypassed
        # admission entirely (ROADMAP tail-latency follow-on).
        self.admission = None
        if admission_rate > 0 or admission_inflight > 0:
            from seaweedfs_tpu_torch.qos.admission import AdmissionController

            self.admission = AdmissionController(
                rate=admission_rate,
                burst=admission_burst,
                max_inflight=admission_inflight,
                procs=admission_procs,
                label=f"volume-worker-{writer_index}",
                shm_path=admission_shm_path,
            )
        # QoS group commit on the worker-owned write path (-shardWrites
        # + -commitWindowUs/-commitFsync): concurrent POSTs for vids
        # this worker owns coalesce into one pwritev + at most one
        # fsync, same as the lead's (qos/group_commit.py). The C POST
        # fast path declines while a committer is installed, exactly
        # like the lead's do_POST.
        self.group_commit = None
        if shard_writes and (commit_window_us > 0 or commit_fsync):
            from seaweedfs_tpu_torch.qos.group_commit import GroupCommitter

            self.group_commit = GroupCommitter(
                window_us=commit_window_us,
                max_bytes=commit_bytes,
                max_batch=commit_batch,
                fsync=commit_fsync,
            )
        self.worker_port = worker_port  # optional private listener (tests)
        # -shardWrites: this worker OWNS writes for vids with
        # vid % n_writers == writer_index (lead is writer 0) — see
        # VolumeServer's shard_writes comment for the ownership story.
        # `released` holds vids handed back to the lead (admin ops,
        # takeovers); their writes proxy like everything else.
        self.shard_writes = shard_writes
        self.writer_index = writer_index
        self.n_writers = max(1, n_writers)
        self.master = master  # for replica fan-out lookups on owned writes
        self.internal_port = internal_port  # own release/control listener
        self.guard = guard  # same security.toml Guard as the lead
        self.released: set[int] = set()
        self._release_lock = threading.Lock()
        self._volumes: dict[int, SharedReadVolume] = {}
        self._vol_lock = threading.Lock()
        self._internal_server: WeedHTTPServer | None = None
        self._servers: list[WeedHTTPServer] = []
        self._threads: list[threading.Thread] = []
        self._profiling = False

    # --- volume discovery ------------------------------------------------
    def _find_volume(self, vid: int) -> SharedReadVolume | None:
        v = self._volumes.get(vid)
        if v is not None:
            return v
        with self._vol_lock:
            v = self._volumes.get(vid)
            if v is not None:
                return v
            for d in self.directories:
                try:
                    names = os.listdir(d)
                except OSError:
                    continue
                for name in names:
                    parsed = parse_volume_file_name(name)
                    if parsed is None or parsed[1] != vid:
                        continue
                    try:
                        v = SharedReadVolume(d, vid, parsed[0])
                    except (OSError, ValueError, RuntimeError):
                        # unreadable, mid-commit, or remote-tiered
                        # (workers carry no backend config) — the lead
                        # serves it via the proxy path
                        return None
                    self._volumes[vid] = v
                    return v
        return None

    def _drop_volume(self, vid: int) -> None:
        with self._vol_lock:
            v = self._volumes.pop(vid, None)
        if v is not None:
            try:
                v.close()
            except OSError:
                pass

    # --- HTTP ------------------------------------------------------------
    def _make_handler(self):
        worker = self

        class Handler(FastHandler):

            def do_GET(self):
                path, _, qs = self.path.partition("?")
                fid_part = path.lstrip("/")
                if "," in fid_part and "/" not in fid_part:
                    q = fast_query(qs)
                    if not ("width" in q or "height" in q):
                        try:
                            fid = FileId.parse(fid_part)
                        except ValueError:
                            fid = None
                        if fid is not None and self._serve_blob(fid):
                            return
                self._proxy()

            do_HEAD = do_GET

            def do_POST(self):
                if self.path.startswith("/__shard/release"):
                    return self._shard_release()
                # body read ONCE: the owned-write path consumes the
                # socket; a declining fallback must hand the SAME bytes
                # to the proxy, not re-read a drained connection
                length = int(self.headers.get("content-length", "0") or 0)
                body = self.rfile.read(length)
                self._hop_owner_declined = False
                if worker.shard_writes and self._try_owned_write("POST", body):
                    return
                self._proxy(body=body)

            def do_DELETE(self):
                self._hop_owner_declined = False
                if worker.shard_writes and self._try_owned_write("DELETE", b""):
                    return
                self._proxy(body=b"")

            def _shard_release(self):
                """Lead handshake: stop writing this vid forever; the
                lead takes ownership once we acknowledge. Internal
                listener ONLY — on the public port an anonymous client
                could strip write ownership vid by vid."""
                if (
                    worker._internal_server is None
                    or self.server is not worker._internal_server
                ):
                    return self._json({"error": "not found"}, 404)
                q = fast_query(self.path.partition("?")[2])
                try:
                    vid = int(q.get("vid", ""))
                except ValueError:
                    return self._json({"error": "bad vid"}, 400)
                with worker._release_lock:
                    worker.released.add(vid)
                    v = worker._volumes.get(vid)
                # in-flight owned writes hold the volume lock (their
                # under-lock precheck ran before our released.add, so
                # they are appending); taking it once AFTER dropping the
                # release lock (writers acquire release_lock inside
                # v._lock — same order here would deadlock) means the
                # ack orders after every append the lead must replay
                if v is not None:
                    with v._lock:
                        pass
                self._json({"released": vid})

            def _try_owned_write(self, method: str, body: bytes) -> bool:
                """True when this worker owned the vid and handled the
                write/delete locally (byte-identical semantics to the
                lead via server.write_path)."""
                from seaweedfs_tpu_torch.server import write_path
                from seaweedfs_tpu_torch.storage.file_id import (
                    parse_path_fid,
                    parse_url_path,
                )

                path, _, qs = self.path.partition("?")
                try:
                    vid_s, fid_str, url_filename, _ext, vid_only = (
                        parse_url_path(path)
                    )
                    if vid_only or not fid_str:
                        return False
                    fid = parse_path_fid(vid_s, fid_str)
                except ValueError:
                    return False
                q = fast_query(qs)
                vid = fid.volume_id
                if vid % worker.n_writers != worker.writer_index:
                    return False
                self._hop_owner_declined = True  # owner from here on
                auth_err = write_path.check_write_auth(
                    worker.guard, self.path, self.headers,
                    self.client_address[0],
                )
                if auth_err is not None:
                    self._json({"error": auth_err}, 401)
                    return True
                with worker._release_lock:
                    if vid in worker.released:
                        return False
                v = worker._find_volume(vid)
                if v is None:
                    return False  # not on disk yet / mid-commit: lead's

                def still_owned():
                    # ONE ownership predicate for the delete, native,
                    # and Python write paths — they must never diverge
                    with worker._release_lock:
                        return vid not in worker.released

                if method == "DELETE":
                    return self._owned_delete(v, fid, q, still_owned)
                # C hot loop first; Python fallback below — both
                # branches converge on the ONE replicate-then-reply
                # tail (same shape as the lead's do_POST)
                req_span = getattr(self, "_trace_span", None)
                stages = {} if req_span is not None else None
                if worker.group_commit is not None:
                    # QoS group commit (docs/QOS.md): the C one-call
                    # append can't join a commit window (and fsync-only
                    # mode needs the post-write flush), so the fast
                    # path declines wholesale while a committer is
                    # installed — same policy as the lead's do_POST
                    reply = None
                else:
                    try:
                        reply = v.native_post(
                            fid, q, body, self.headers, url_filename,
                            precheck=still_owned, stages=stages,
                        )
                    except VolumeReleased:
                        return False  # re-route to the lead (new owner)
                    except (CookieMismatch, ValueError) as e:
                        # same contract as the Python branch below: a
                        # refresh/reopen failure (CorruptNeedle is a
                        # ValueError) answers 409, never a dropped socket
                        self._json({"error": str(e)}, 409)
                        return True
                    except OSError:
                        worker._drop_volume(vid)
                        return False
                if reply is None:
                    n, fname, err = write_path.build_upload_needle(
                        fid, q, body, self.headers, url_filename,
                        fix_jpg_orientation=True, stages=stages,
                    )
                    if err is not None:
                        self._json({"error": err}, 400)
                        return True
                    try:
                        if worker.group_commit is not None:
                            _, size, unchanged = worker.group_commit.write(
                                _CommitVolume(v, still_owned), n,
                                stages=stages,
                            )
                        else:
                            size, unchanged = v.write_needle(
                                n, precheck=still_owned, stages=stages
                            )
                    except VolumeReleased:
                        return False  # re-route to the lead (new owner)
                    except (CookieMismatch, ValueError) as e:
                        self._json({"error": str(e)}, 409)
                        return True
                    except OSError:
                        worker._drop_volume(vid)
                        return False
                    import json as _json

                    reply = (
                        b'{"name": %s, "size": %d, "eTag": "%s"}'
                        % (_json.dumps(fname).encode(), size, n.etag().encode())
                    )
                if stages:
                    req_span.add_stages(stages)
                if q.get("type") != "replicate":
                    err = self._replicate_owned(v, fid, q, body)
                    if err:
                        self._json({"error": err}, 500)
                        return True
                self.fast_reply(201, reply, JSON_HDR)
                return True

            def _owned_delete(self, v, fid, q, still_owned) -> bool:
                n = Needle(cookie=fid.cookie, id=fid.key)
                try:
                    existing = v.read_needle(fid.key, cookie=fid.cookie)
                    if existing.is_chunked_manifest():
                        # manifest cascade needs the lead's fan-out
                        return False
                    v.delete_needle(n, precheck=still_owned)
                except VolumeReleased:
                    return False
                except NeedleNotFound:
                    self._json({"size": 0}, 404)
                    return True
                except CookieMismatch as e:
                    self._json({"error": str(e)}, 409)
                    return True
                except OSError:
                    worker._drop_volume(fid.volume_id)
                    return False
                # first-hop deletes fan out to replica peers exactly
                # like the lead's do_DELETE — an acknowledged delete
                # that skipped its replicas would resurrect there
                # (reference ReplicatedDelete, store_replicate.go)
                if q.get("type") != "replicate":
                    err = self._replicate_owned(
                        v, fid, q, b"", method="DELETE"
                    )
                    if err:
                        self._json({"error": err}, 500)
                        return True
                # 202 Accepted, matching the lead's do_DELETE reply
                self._json({"size": existing.size}, 202)
                return True

            def _replicate_owned(
                self, v, fid, q, body, method: str = "POST"
            ) -> str | None:
                """Replica fan-out for a write/delete this worker
                first-hop owns (store_replicate.go:44): peers looked up
                at the master, self excluded by the SHARED public
                host:port."""
                from seaweedfs_tpu_torch.server import write_path

                rp = v.volume.super_block.replica_placement
                if rp.copy_count <= 1 or not worker.master:
                    return None
                from seaweedfs_tpu_torch.client import operation as op

                try:
                    res = op.lookup(worker.master, str(fid.volume_id))
                except (OSError, RuntimeError) as e:
                    return f"replication lookup failed: {e}"
                if res.error:
                    return "replication lookup failed"
                me = f"{worker.host}:{worker.port}"
                locations = [
                    u for u in dict.fromkeys(l["url"] for l in res.locations)
                    if u != me
                ]
                # the lead's contract: never acknowledge a write with
                # fewer copies than its placement asks for
                if len(locations) + 1 < rp.copy_count:
                    return (
                        f"replicating operations [{len(locations) + 1}] is "
                        f"less than volume {fid.volume_id} replication copy "
                        f"count [{rp.copy_count}]"
                    )
                return write_path.replicate_to_peers(
                    fid, q, method, body, self.headers, locations
                )

            def _serve_blob(self, fid) -> bool:
                """True when served locally; False = hand to the proxy
                (unknown volume, EC volume, chunk manifest, expired…)."""
                v = worker._find_volume(fid.volume_id)
                if v is None:
                    return False
                try:
                    n = v.read_needle(fid.key, cookie=fid.cookie)
                except FileNotFoundError:
                    worker._drop_volume(fid.volume_id)
                    return False
                except CookieMismatch:
                    self._json({"error": "cookie mismatch"}, 404)
                    return True
                except NeedleNotFound:
                    self._json({"error": "not found"}, 404)
                    return True
                except (OSError, ValueError, RuntimeError):
                    worker._drop_volume(fid.volume_id)
                    return False
                if n.is_chunked_manifest():
                    return False  # manifest fan-in needs the lead's store
                if (
                    n.is_gzipped()
                    or n.has_pairs()
                    or self.headers.get("etag-md5") == "True"
                ):
                    # content-encoding negotiation, pair headers, and the
                    # md5-validator variant live in the lead's full
                    # read handler
                    return False
                if n.has_last_modified_date():
                    ims = self.headers.get("if-modified-since")
                    if ims:
                        from email.utils import parsedate_to_datetime

                        try:
                            t = parsedate_to_datetime(ims).timestamp()
                        except (TypeError, ValueError):
                            t = None
                        if t is not None and t >= n.last_modified:
                            self.fast_reply(304)
                            return True
                etag = f'"{n.etag()}"'
                # RFC 9110 §13.1.2: weak compare over a quote-aware
                # comma list (W/"…", multiple members, `*`) — the same
                # scanner the lead's do_GET and the C loop run
                if etag_matches(self.headers.get("if-none-match", ""), etag):
                    self.fast_reply(304)
                    return True
                # header assembly mirrors the lead's do_GET for a bare
                # fid URL (and the shared plan core the C arm serves
                # from) — octet-stream mimes stay implicit, extension
                # fallback, escaped filename — so a worker's threaded
                # reply is byte-identical to the lead's and to the C
                # fast path for the same needle
                headers = {
                    "ETag": etag,
                    "Content-Type": "application/octet-stream",
                }
                fname = (
                    n.name.decode("latin-1")
                    if n.has_name() and n.name
                    else ""
                )
                if (
                    n.has_mime()
                    and n.mime
                    and not n.mime.startswith(b"application/octet-stream")
                ):
                    headers["Content-Type"] = n.mime.decode("latin-1")
                elif fname:
                    import mimetypes
                    from os.path import splitext

                    ext = splitext(fname)[1]
                    guessed = (
                        mimetypes.types_map.get(ext.lower()) if ext else None
                    )
                    if guessed:
                        headers["Content-Type"] = guessed
                if fname:
                    escaped = fname.replace("\\", "\\\\").replace('"', '\\"')
                    headers["Content-Disposition"] = (
                        f'inline; filename="{escaped}"'
                    )
                if n.has_last_modified_date():
                    from seaweedfs_tpu_torch.server.volume_server import _http_date

                    headers["Last-Modified"] = _http_date(n.last_modified)
                headers["Accept-Ranges"] = "bytes"
                data = n.data
                from seaweedfs_tpu_torch.util.http_range import (
                    RangeNotSatisfiable,
                    parse_range,
                )

                try:
                    span = parse_range(self.headers.get("range", ""), len(data))
                except RangeNotSatisfiable:
                    self.fast_reply(
                        416, b"", {"Content-Range": f"bytes */{len(data)}"}
                    )
                    return True
                if span is None:
                    self.fast_reply(200, data, headers)
                else:
                    start, end = span
                    headers["Content-Range"] = (
                        f"bytes {start}-{end}/{len(data)}"
                    )
                    self.fast_reply(206, data[start : end + 1], headers)
                return True

            def _json(self, obj, status=200):
                import json

                self.fast_reply(status, json.dumps(obj).encode(), JSON_HDR)

            def _proxy(self, body: bytes | None = None):
                """Forward this request verbatim to the lead and relay
                the response (one pooled keep-alive conn per handler
                thread, via the client transport). `body` carries
                already-consumed request bytes (the owned-write path
                reads the socket before deciding to decline)."""
                from seaweedfs_tpu_torch.client.operation import _drop_conn, _pooled_conn

                if body is None and self.command in ("POST", "PUT", "DELETE"):
                    try:
                        n = int(self.headers.get("content-length", "0"))
                    except ValueError:
                        n = 0
                    body = self.rfile.read(n) if n else b""
                fwd = {
                    k: v
                    for k, v in self.headers.items()
                    if k not in _HOP_HEADERS
                }
                # re-stamp the trace header with THIS hop's span so the
                # lead's span parents under the worker hop, keeping the
                # x-shard-hop forwarding chain on one trace
                from seaweedfs_tpu_torch import trace as _trace

                _trace.inject(fwd)
                if getattr(self, "_hop_owner_declined", False):
                    # tells the lead: this request already visited the
                    # vid's OWNER, which declined (released volume,
                    # manifest cascade, mid-commit) — handle it there
                    # after taking ownership; never route it back. A
                    # NON-owner's proxy must NOT set this, or the lead
                    # would seize vids of healthy third workers
                    # (-workers >= 3).
                    fwd["x-shard-hop"] = "1"
                try:
                    c, reused = _pooled_conn(worker.lead, 30.0)
                    try:
                        c.send_request(self.command, self.path, body, fwd)
                        status, rheaders, data, will_close = c.read_response(
                            self.command
                        )
                    except OSError:
                        _drop_conn(worker.lead)
                        if not reused:
                            raise
                        c, _ = _pooled_conn(worker.lead, 30.0)
                        c.send_request(self.command, self.path, body, fwd)
                        status, rheaders, data, will_close = c.read_response(
                            self.command
                        )
                    if will_close:
                        _drop_conn(worker.lead)
                except OSError as e:
                    return self._json({"error": f"lead unreachable: {e}"}, 502)
                out = {
                    k: v for k, v in rheaders.items() if k not in _HOP_HEADERS
                }
                self.fast_reply(status, data, out)

            do_PUT = _proxy

        return Handler

    # --- zero-copy GET fast path (docs/SERVING.md) -----------------------
    # Workers previously left every GET on the threaded arm: only the
    # lead's listener carried a resolver, so under `-workers N` just
    # 1-in-N connections could be served from C. This resolver runs the
    # SAME shared plan core against the worker's SharedReadVolume view
    # (idx-tail refresh first, same as _serve_blob), so every
    # SO_REUSEPORT sibling answers hot GETs — and If-None-Match 304s —
    # without leaving its C epoll loop.
    def _make_fast_resolver(self):
        from seaweedfs_tpu_torch.server.volume_server import make_needle_plan_core
        from seaweedfs_tpu_torch.util.httpd import reply_prefix

        plan_core = make_needle_plan_core()
        prefix_304 = reply_prefix(304)
        json_404 = reply_prefix(404) + JSON_HDR
        # the worker's threaded arm 404s with JSON bodies (unlike the
        # lead's empty 404), and distinguishes cookie mismatch — the C
        # arm must serve those exact bytes. No etag on either: a 404
        # can never answer a conditional, matching _serve_blob.
        not_found = (404, json_404, b'{"error": "not found"}',
                     -1, 0, 0, None, prefix_304, 0, 0)
        cookie_404 = (404, json_404, b'{"error": "cookie mismatch"}',
                      -1, 0, 0, None, prefix_304, 0, 0)
        worker = self

        def resolver(path, rng, head_only):
            adm = worker.admission
            if adm is not None and not getattr(adm, "shared", False):
                # per-process rate/N buckets live in the dispatch
                # funnel only; declining routes every request through
                # it. The SHARED (shm) bucket is charged by the C loop
                # itself, so the fast path stays native.
                return None
            if "?" in path:
                return None
            fid_part = path.lstrip("/")
            if "," not in fid_part or "/" in fid_part:
                return None  # UI/status/admin surface proxies the lead
            try:
                fid = FileId.parse(fid_part)
            except ValueError:
                return None
            srv = worker._find_volume(fid.volume_id)
            if srv is None:
                return None  # unknown/EC/mid-commit: proxy decides
            try:
                with srv._lock:
                    srv._refresh()
                # plans are NEVER cacheable here (gen 0, cacheable 0):
                # the lead (and shard siblings) append from other
                # processes, invisible to this process's generation
                # counter — every request must re-run the refresh
                out = plan_core(srv._vol, fid, rng, head_only, 0, 0)
            except (OSError, ValueError, RuntimeError):
                return None  # reopen straddling a vacuum commit:
                # the threaded arm retries with a fresh pair
            if out is None:
                return None
            if out[0] == "notfound":
                return not_found
            if out[0] == "cookie":
                return cookie_404
            return out[1]

        return resolver

    # --- lifecycle --------------------------------------------------------
    def start(self) -> None:
        from seaweedfs_tpu_torch.util.httpd import ReusePortWeedHTTPServer

        handler = self._make_handler()
        if self.shard_writes and self.internal_port:
            # the release/control listener must be up BEFORE any public
            # write can arrive: the lead treats connection-refused on a
            # release call as "worker dead" and takes the vid over —
            # accepting public writes first would race that takeover
            self._internal_server = WeedHTTPServer(
                ("127.0.0.1", self.internal_port), handler
            )
            self._servers.append(self._internal_server)
        if self.shard_writes:
            self._load_taken_vids()
        srv = ReusePortWeedHTTPServer((self.host, self.port), handler)
        self._servers.append(srv)
        if self.worker_port:
            self._servers.append(
                WeedHTTPServer((self.host, self.worker_port), handler)
            )
        # zero-copy GET fast path on every public listener: without
        # this only the lead's 1-in-N share of SO_REUSEPORT accepts
        # ever reached serve.c. The internal
        # release/control listener stays resolver-less — it is a
        # lead↔worker write/admin hop, never a data-plane GET.
        fast_resolver = self._make_fast_resolver()
        for s in self._servers:
            if s is not self._internal_server:
                s.fast_resolver = fast_resolver
        for s in self._servers:
            # tracing plane: worker hops are spans too, labeled so a
            # shard-hop write reads worker→lead→replica in one trace
            s.trace_name = "worker"
            s.trace_node = f"{self.host}:{self.port}#w{self.writer_index}"
            # admission gates the PUBLIC surfaces only: the internal
            # release/control listener is a trusted lead↔worker hop —
            # shedding it could wedge an ownership handback mid-admin-op
            if s is not self._internal_server:
                s.admission = self.admission
            t = threading.Thread(target=s.serve_forever, daemon=True)
            t.start()
            self._threads.append(t)
        # a serve loop that could not arm raises here, not later
        for s in self._servers:
            s.wait_armed()
        # telemetry plane: workers serve /debug/profile too — a GIL
        # stall in one SO_REUSEPORT process is invisible from the lead
        from seaweedfs_tpu_torch.telemetry import profiler

        self._profiling = profiler.ensure_started()
        wlog.info(
            "volume %s worker %d on %s:%d (lead %s)",
            "write" if self.shard_writes else "read",
            self.writer_index,
            self.host,
            self.port,
            self.lead,
        )

    def _load_taken_vids(self) -> None:
        """Vids the lead already took over (e.g. a takeover while this
        worker was starting) must never be written here."""
        import json
        import urllib.request

        try:
            # weedlint: ignore[no-deadline] — boot-time localhost hop to the lead, 10 s cap; runs before any request deadline can exist
            with urllib.request.urlopen(
                f"http://{self.lead}/__shard/taken", timeout=10
            ) as r:
                taken = json.loads(r.read())
        except (OSError, ValueError):
            return  # lead not up yet: it cannot have taken anything over
        with self._release_lock:
            self.released.update(int(v) for v in taken)

    def stop(self) -> None:
        """Stop serving: every listener's thread has ended and this
        worker's hold on the sampling profiler is released when this
        returns."""
        for s in self._servers:
            s.shutdown()
            s.server_close()
        self._servers.clear()
        for t in self._threads:
            t.join(timeout=10)
        self._threads.clear()
        if self._profiling:
            from seaweedfs_tpu_torch.telemetry import profiler

            profiler.release()
            self._profiling = False
        # the volume-table drain takes _vol_lock like every other
        # mutation of _volumes: a handler thread finishing its last
        # response can still be inside _find_volume when stop() runs
        # (the reference lint's unguarded-write finding)
        with self._vol_lock:
            volumes = list(self._volumes.values())
            self._volumes.clear()
        for v in volumes:
            try:
                v.close()
            except OSError:
                pass


def spawn_read_workers(
    n: int,
    directories: list[str],
    host: str,
    port: int,
    lead_internal: str,
    worker_port_base: int = 0,
    shard_writes: bool = False,
    n_writers: int = 1,
    master: str = "",
    internal_base: int = 0,
    admission_rate: float = 0.0,
    admission_burst: float = 0.0,
    admission_inflight: int = 0,
    admission_procs: int = 1,
    admission_shm_path: str = "",
    commit_window_us: int = 0,
    commit_bytes: int = 4 << 20,
    commit_batch: int = 64,
    commit_fsync: bool = False,
) -> list:
    """Lead-side helper: launch n worker subprocesses sharing host:port
    (writer indices 1..n; the lead is writer 0). Returns the Popen
    handles (terminate them on shutdown)."""
    import subprocess
    import sys

    procs = []
    for k in range(n):
        cmd = [
            sys.executable,
            "-m",
            "seaweedfs_tpu_torch",
            "volume.worker",
            "-ip",
            host,
            "-port",
            str(port),
            "-dir",
            ",".join(directories),
            "-lead",
            lead_internal,
        ]
        if worker_port_base:
            cmd += ["-workerPort", str(worker_port_base + k)]
        if admission_rate > 0 or admission_inflight > 0:
            # with a shm path every member charges ONE shared bucket;
            # without it each enforces 1/procs of the per-client
            # budget — the legacy SO_REUSEPORT sibling convention
            cmd += [
                "-admissionRate", str(admission_rate),
                "-admissionBurst", str(admission_burst),
                "-admissionInflight", str(admission_inflight),
                "-admissionProcs", str(admission_procs),
            ]
            if admission_shm_path:
                cmd += ["-admissionShmPath", admission_shm_path]
        if shard_writes:
            cmd += [
                "-shardWrites",
                "-writerIndex", str(k + 1),
                "-writers", str(n_writers),
                "-internalPort", str(internal_base + k + 1),
            ]
            if master:
                cmd += ["-mserver", master]
            if commit_window_us > 0 or commit_fsync:
                cmd += [
                    "-commitWindowUs", str(commit_window_us),
                    "-commitBytes", str(commit_bytes),
                    "-commitBatch", str(commit_batch),
                ]
                if commit_fsync:
                    cmd += ["-commitFsync"]
        procs.append(subprocess.Popen(cmd))
    return procs
