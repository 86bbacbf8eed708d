"""Filer server: HTTP namespace gateway + gRPC service.

Behavioral match of weed/server/filer_server*.go:

  * POST /path — assign a fid from the master, proxy the body to the
    volume server, create the entry; bodies over max_mb are split into
    chunks each under its own fid (filer_server_handlers_write.go:41,
    _write_autochunk.go:23 autoChunk);
  * GET /path — files stream their chunk views from volume servers
    (filer2/stream.go); directories list as JSON (readerAt the UI role);
  * DELETE /path?recursive=true — entry + async chunk GC;
  * gRPC — the 11-verb Filer service incl. AtomicRenameEntry inside a
    store transaction (filer_grpc_server.go, _rename.go).

The port of seaweedfs_tpu/server/filer_server.py. The filer holds no
codec and never touches the card: a chunk on an EC volume is read
through a shard holder's HTTP GET, and that holder decodes it (on its
card when it lost shards). /metrics carries the producer-side
replication lag: the depth of the "replicate" consumer group in the
process's notification queue. stop() ends every thread start() made.
"""

from __future__ import annotations

import json
import threading
import time
from concurrent import futures
from urllib.parse import parse_qs, unquote, urlparse

import grpc

from seaweedfs_tpu_torch.client import operation as op
from seaweedfs_tpu_torch.util import wlog
from seaweedfs_tpu_torch.filer import filechunks, stream
from seaweedfs_tpu_torch.filer.entry import Attr, Entry, normalize_path
from seaweedfs_tpu_torch.filer.filer import Filer
from seaweedfs_tpu_torch.filer.filerstore import EntryNotFound, new_store
from seaweedfs_tpu_torch.pb import filer_pb2 as fpb
from seaweedfs_tpu_torch.util.httpd import FastHandler, WeedHTTPServer
from seaweedfs_tpu_torch.pb import rpc
from seaweedfs_tpu_torch.stats.metrics import DEFAULT_REGISTRY, REPLICATION_LAG


def _sample_repl_lag() -> None:
    """The producer's view of consumer lag on the filer's /metrics: the
    depth of the "replicate" consumer group in the process's notification
    queue, which the collector scrapes and RULE_REPL_LAG alerts on. It is
    read when /metrics renders, so an idle filer pays nothing; the
    registry and the queue are process-wide, so the hook is one per
    process however many filers it embeds."""
    from seaweedfs_tpu_torch import notification

    depth = getattr(notification.queue, "depth", None)
    if callable(depth):
        try:
            REPLICATION_LAG.set(depth("replicate"), "replicate")
        except OSError:
            pass


DEFAULT_REGISTRY.add_prerender_hook(_sample_repl_lag)


def _queue_publisher():
    """Default on_event: publish EventNotifications to the process
    notification queue when one is configured (filer_notify.go:9-39).
    Returns None when no queue is set so the filer skips the work."""
    from seaweedfs_tpu_torch import notification

    if notification.queue is None:
        return None

    def publish(old, new, delete_chunks: bool) -> None:
        if notification.queue is None:  # queue torn down after start
            return
        key = (old or new).full_path
        msg = fpb.EventNotification(delete_chunks=delete_chunks)
        if old is not None:
            msg.old_entry.CopyFrom(old.to_pb())
        if new is not None:
            msg.new_entry.CopyFrom(new.to_pb())
            msg.new_parent_path = new.directory
        try:
            notification.queue.send_message(key, msg)
        except Exception as e:  # noqa: BLE001 — never fail the write
            # the entry is already durably stored; a broker hiccup must
            # not turn the client's POST into a 500 (filer_notify.go
            # logs SendMessage errors and continues). Matters since the
            # kafka queue does real network IO; embedded queues never
            # raised here.
            wlog.error("notify %s: %s", key, e)

    return publish


class FilerServer:
    def __init__(
        self,
        masters: list[str],
        host: str = "127.0.0.1",
        port: int = 8888,
        store: str = "memory",
        store_path: str = "",
        collection: str = "",
        replication: str = "",
        max_mb: int = 32,
        on_event=None,
        announce_interval: float = 10.0,
    ):
        self.masters = masters
        self.announce_interval = announce_interval
        self._announce: threading.Thread | None = None
        self._master_idx = 0  # rotates on failure (HA master failover)
        self.host = host
        self.port = port
        self.grpc_port = port + 10000
        self.collection = collection
        self.replication = replication
        self.max_mb = max_mb
        self.filer = Filer(
            new_store(store, store_path),
            masters,
            on_event=on_event or _queue_publisher(),
        )
        self._grpc_server: grpc.Server | None = None
        self._grpc_pool: futures.ThreadPoolExecutor | None = None
        self._http_server: WeedHTTPServer | None = None
        self._http_thread: threading.Thread | None = None
        self._profiling = False

    # ------------------------------------------------------------------
    # master failover: any live master serves (non-leaders proxy writes
    # to the leader), so calls rotate through the seed list on failure
    def _with_master(self, fn):
        out, idx = op.with_master_failover(self.masters, fn, self._master_idx)
        self._master_idx = idx
        return out

    def _read_master(self, entry) -> str:
        """A master that can actually resolve this entry's chunks.

        Probes with a real LookupVolume of the first chunk's vid, so a
        follower with a stale leader pointer (which aborts UNAVAILABLE)
        rotates away BEFORE the 200 header goes out — a mid-stream
        lookup failure can only truncate the response. Success results
        are cached by op.lookup, so the steady-state cost is nil."""
        chunks = list(entry.chunks)
        if not chunks:
            return self.masters[self._master_idx % len(self.masters)]
        vid = chunks[0].fid.split(",")[0]

        def probe(m):
            res = op.lookup(m, vid)
            if res.error or not res.locations:
                # in-band leader answer ("volume not found"): do NOT
                # rotate — every master proxies to the same leader
                raise RuntimeError(
                    f"lookup {vid} via {m}: {res.error or 'no locations'}"
                )
            return m

        return self._with_master(probe)

    # ------------------------------------------------------------------
    # write path helpers
    def _assign(self, collection: str = "", replication: str = "", ttl: str = "") -> op.AssignResult:
        return self._with_master(
            lambda m: op.assign(
                m,
                collection=collection or self.collection,
                replication=replication or self.replication,
                ttl=ttl,
            )
        )

    def _upload_bytes(
        self, data: bytes, filename: str, mime: str, collection: str, replication: str, ttl: str
    ) -> list:
        """Upload `data` as 1..N chunks (autoChunk when over max_mb)."""
        chunk_size = self.max_mb * 1024 * 1024
        chunks = []
        offset = 0
        now_ns = time.time_ns()
        while True:
            piece = data[offset : offset + chunk_size] if chunk_size else data
            ar = self._assign(collection, replication, ttl)
            ur = op.upload(
                f"{ar.url}/{ar.fid}",
                piece,
                filename=filename,
                mime=mime,
                ttl=ttl,
                jwt=ar.auth,
            )
            if ur.error:
                raise RuntimeError(f"upload chunk: {ur.error}")
            chunks.append(
                filechunks.make_chunk(
                    ar.fid, offset, len(piece), now_ns + offset, e_tag=ur.etag
                )
            )
            offset += len(piece)
            if offset >= len(data):
                break
        return chunks

    # ------------------------------------------------------------------
    # gRPC servicer (filer_grpc_server.go)
    def LookupDirectoryEntry(self, req: fpb.LookupDirectoryEntryRequest, context):
        try:
            entry = self.filer.find_entry(f"{req.directory}/{req.name}")
        except EntryNotFound:
            context.abort(grpc.StatusCode.NOT_FOUND, f"{req.directory}/{req.name}")
        return fpb.LookupDirectoryEntryResponse(entry=entry.to_pb())

    def ListEntries(self, req: fpb.ListEntriesRequest, context):
        entries = self.filer.list_entries(
            req.directory,
            start_file_name=req.start_from_file_name,
            include_start=req.inclusive_start_from,
            limit=req.limit or 1024,
            prefix=req.prefix,
        )
        for e in entries:
            yield fpb.ListEntriesResponse(entry=e.to_pb())

    def CreateEntry(self, req: fpb.CreateEntryRequest, context):
        entry = Entry.from_pb(req.directory, req.entry)
        self.filer.create_entry(entry)
        return fpb.CreateEntryResponse()

    def UpdateEntry(self, req: fpb.UpdateEntryRequest, context):
        entry = Entry.from_pb(req.directory, req.entry)
        try:
            old = self.filer.find_entry(entry.full_path)
        except EntryNotFound:
            context.abort(grpc.StatusCode.NOT_FOUND, entry.full_path)
        garbage = filechunks.minus_chunks(old.chunks, entry.chunks)
        self.filer.update_entry(entry)
        if garbage:
            self.filer.delete_chunks_async([c.fid for c in garbage])
        return fpb.UpdateEntryResponse()

    def DeleteEntry(self, req: fpb.DeleteEntryRequest, context):
        try:
            self.filer.delete_entry(
                f"{req.directory}/{req.name}",
                is_recursive=req.is_recursive,
                delete_data=req.is_delete_data,
            )
        except EntryNotFound:
            pass
        except ValueError as e:
            context.abort(grpc.StatusCode.FAILED_PRECONDITION, str(e))
        return fpb.DeleteEntryResponse()

    def AtomicRenameEntry(self, req: fpb.AtomicRenameEntryRequest, context):
        try:
            self.filer.atomic_rename(
                f"{req.old_directory}/{req.old_name}",
                f"{req.new_directory}/{req.new_name}",
            )
        except EntryNotFound as e:
            context.abort(grpc.StatusCode.NOT_FOUND, str(e))
        return fpb.AtomicRenameEntryResponse()

    def AssignVolume(self, req: fpb.AssignVolumeRequest, context):
        ar = self._assign(req.collection, req.replication)
        return fpb.AssignVolumeResponse(
            fid=ar.fid,
            url=ar.url,
            public_url=ar.public_url,
            count=ar.count,
            auth=ar.auth,
        )

    def LookupVolume(self, req: fpb.LookupVolumeRequest, context):
        out = fpb.LookupVolumeResponse()
        for vid in req.volume_ids:
            res = self._with_master(lambda m: op.lookup(m, vid))
            locs = out.locations_map[vid]
            for l in res.locations:
                locs.locations.add(url=l["url"], public_url=l["publicUrl"])
        return out

    def DeleteCollection(self, req: fpb.DeleteCollectionRequest, context):
        from seaweedfs_tpu_torch.pb import master_pb2
        from seaweedfs_tpu_torch.pb.rpc import grpc_address

        def call(m):
            with rpc.dial(grpc_address(m)) as ch:
                rpc.master_stub(ch).CollectionDelete(
                    master_pb2.CollectionDeleteRequest(name=req.collection)
                )

        self._with_master(call)
        return fpb.DeleteCollectionResponse()

    def Statistics(self, req: fpb.StatisticsRequest, context):
        from seaweedfs_tpu_torch.pb import master_pb2
        from seaweedfs_tpu_torch.pb.rpc import grpc_address

        def call(m):
            with rpc.dial(grpc_address(m)) as ch:
                return rpc.master_stub(ch).Statistics(
                    master_pb2.StatisticsRequest(
                        replication=req.replication,
                        collection=req.collection,
                        ttl=req.ttl,
                    )
                )

        resp = self._with_master(call)
        return fpb.StatisticsResponse(
            total_size=resp.total_size,
            used_size=resp.used_size,
            file_count=resp.file_count,
        )

    def GetFilerConfiguration(self, req, context):
        return fpb.GetFilerConfigurationResponse(
            masters=self.masters,
            replication=self.replication,
            collection=self.collection,
            max_mb=self.max_mb,
        )

    # ------------------------------------------------------------------
    # directory browser (server/filer_ui/templates.go role)
    def _render_dir_html(
        self, path: str, entries, limit: int, last: str, more: bool
    ) -> str:
        """Breadcrumbed directory listing for browsers, with the
        reference's lastFileName/limit load-more pagination link
        (filer_ui/templates.go, breadcrumb.go ToBreadcrumb)."""
        import html as _html
        import time as _time
        from urllib.parse import quote

        from seaweedfs_tpu_torch.util.status_ui import status_page

        crumbs = ["<a href='/'>/</a>"]
        parts = [p for p in path.split("/") if p]
        for i, part in enumerate(parts):
            link = quote("/" + "/".join(parts[: i + 1]) + "/")
            crumbs.append(f"<a href='{link}'>{_html.escape(part)} /</a>")
        rows = []
        for e in entries:
            name = _html.escape(e.name)
            href = quote(e.full_path) + ("/" if e.is_directory else "")
            size = "" if e.is_directory else str(e.size())
            mtime = (
                _time.strftime(
                    "%Y-%m-%d %H:%M:%S", _time.localtime(e.attr.mtime)
                )
                if e.attr.mtime
                else ""
            )
            mime = "dir" if e.is_directory else _html.escape(e.attr.mime or "")
            rows.append(
                f"<tr><td><a href='{href}'>{name}</a></td>"
                f"<td>{size}</td><td>{mtime}</td><td>{mime}</td></tr>"
            )
        if more:
            next_link = (
                quote(path) + f"/?limit={limit}&lastFileName={quote(last)}"
                if path != "/"
                else f"/?limit={limit}&lastFileName={quote(last)}"
            )
            rows.append(
                f"<tr><td colspan=4><a href='{next_link}'>load more…</a>"
                "</td></tr>"
            )
        return status_page(
            "SeaweedFS-TPU Filer",
            " ".join(crumbs),
            f"{len(entries)} entries &middot; limit {limit}",
            ["Name", "Size", "Modified", "Type"],
            "".join(rows),
            ["/", "/metrics"],
            section_heading="Entries",
        )

    # ------------------------------------------------------------------
    # HTTP
    def _http_handler_class(self):
        server = self

        class Handler(FastHandler):
            # FastHandler rides WeedHTTPServer's mini request loop
            # (one-scan head parse, FastHeaders, body realignment —
            # util/httpd.serve_connection); the send_response/
            # send_header slow paths below are untouched

            def _reply(self, status, body=b"", headers=None):
                self.send_response(status)
                for k, v in (headers or {}).items():
                    self.send_header(k, v)
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                if self.command != "HEAD" and body:
                    self.wfile.write(body)

            def _json(self, obj, status=200):
                self._reply(
                    status,
                    json.dumps(obj).encode(),
                    {"Content-Type": "application/json"},
                )

            def _path_and_query(self):
                url = urlparse(self.path)
                return (
                    normalize_path(unquote(url.path)),
                    {k: v[0] for k, v in parse_qs(url.query).items()},
                )

            def do_GET(self):
                path, q = self._path_and_query()
                try:
                    entry = server.filer.find_entry(path)
                except EntryNotFound:
                    return self._json({"error": "not found"}, 404)
                if entry.is_directory:
                    try:
                        limit = max(1, int(q.get("limit", "100")))
                    except ValueError:
                        limit = 100
                    # limit+1 fetch decides the pagination flag exactly
                    # (the reference's extra-entry trick) — no phantom
                    # load-more page on exact-multiple directories
                    entries = server.filer.list_entries(
                        path,
                        start_file_name=q.get("lastFileName", ""),
                        limit=limit + 1,
                    )
                    more = len(entries) > limit
                    entries = entries[:limit]
                    last = entries[-1].name if entries else q.get("lastFileName", "")
                    # browsers get the breadcrumbed HTML listing the
                    # reference renders (filer_ui/templates.go via
                    # filer_server_handlers_read_dir.go:16-45); API
                    # clients keep the JSON shape
                    if "text/html" in self.headers.get("Accept", ""):
                        return self._reply(
                            200,
                            server._render_dir_html(
                                path, entries, limit, last, more
                            ).encode(),
                            {"Content-Type": "text/html; charset=utf-8"},
                        )
                    return self._json(
                        {
                            "Path": path,
                            "Entries": [
                                {
                                    "FullPath": e.full_path,
                                    "IsDirectory": e.is_directory,
                                    "Size": e.size(),
                                    "Mtime": e.attr.mtime,
                                    "Mime": e.attr.mime,
                                }
                                for e in entries
                            ],
                            "Limit": limit,
                            "LastFileName": last,
                            "ShouldDisplayLoadMore": more,
                        }
                    )
                headers = {
                    "Content-Type": entry.attr.mime or "application/octet-stream",
                    "ETag": filechunks.etag(entry.chunks) if entry.chunks else "",
                }
                # entry.size() honors an explicit file_size (truncate
                # may clamp below the chunk total)
                total = entry.size()
                headers["Accept-Ranges"] = "bytes"
                status, offset, length = 200, 0, total
                from seaweedfs_tpu_torch.util.http_range import (
                    RangeNotSatisfiable,
                    parse_range,
                )

                try:
                    span = parse_range(self.headers.get("Range", ""), total)
                except RangeNotSatisfiable:
                    self.send_response(416)
                    self.send_header("Content-Range", f"bytes */{total}")
                    self.send_header("Content-Length", "0")
                    self.end_headers()
                    return
                if span is not None:
                    start, end = span
                    status, offset, length = 206, start, end - start + 1
                    headers["Content-Range"] = f"bytes {start}-{end}/{total}"
                # resolve a master that can serve the chunks BEFORE the
                # status line goes out: a probe failure here is a clean
                # 503, not a 200 with a truncated body
                try:
                    read_master = server._read_master(entry)
                except (RuntimeError, OSError, grpc.RpcError) as e:
                    return self._json({"error": str(e)}, 503)
                self.send_response(status)
                for k, v in headers.items():
                    if v:
                        self.send_header(k, v)
                self.send_header("Content-Length", str(length))
                self.end_headers()
                if self.command == "HEAD":
                    # size/etag come from metadata alone — no chunk I/O
                    return
                written = 0
                try:
                    for piece in stream.stream_content(
                        read_master, entry.chunks, offset, length
                    ):
                        self.wfile.write(piece)
                        written += len(piece)
                except (RuntimeError, OSError):
                    pass
                if written < length:
                    # failure or sparse hole after headers: truncate so
                    # the client sees a short read, not silent corruption
                    # (compare against the RESPONSE length — a completed
                    # 206 must keep the connection reusable)
                    self.close_connection = True

            do_HEAD = do_GET

            def do_POST(self):
                path, q = self._path_and_query()
                # normalize_path strips trailing slashes, so check the
                # raw URL to tell "POST /dir/" (mkdir) from "POST /dir"
                raw_path = unquote(urlparse(self.path).path)
                if "chunked" in self.headers.get(
                    "Transfer-Encoding", ""
                ).lower():
                    # chunked uploads (Go clients PUT unknown-length
                    # readers this way); an unread chunked body would
                    # desync the keep-alive connection
                    try:
                        data = self._read_chunked_body()
                    except ValueError as e:
                        self.close_connection = True
                        return self._json({"error": str(e)}, 400)
                    length = len(data)
                else:
                    length = int(self.headers.get("Content-Length", "0"))
                    data = self.rfile.read(length)
                mime = self.headers.get("Content-Type", "")
                upload_filename = ""
                if mime.lower().startswith("multipart/form-data"):
                    # `curl -F` form uploads (filer_server_handlers_write.go
                    # parses the same way through ParseUpload)
                    from seaweedfs_tpu_torch.util.multipart import (
                        MalformedUpload,
                        parse_upload,
                    )

                    try:
                        p = parse_upload(data, mime)
                    except MalformedUpload as e:
                        return self._json({"error": str(e)}, 400)
                    data, mime = p.data, p.mime
                    upload_filename = p.filename
                    if upload_filename and raw_path.endswith("/"):
                        # form upload INTO a directory: store the file
                        # under its form filename, don't mkdir
                        path = f"{path.rstrip('/')}/{upload_filename}"
                        raw_path = path
                if (raw_path.endswith("/") and raw_path != "/") or (
                    not data and not length and self.command == "POST"
                ):
                    # mkdir (the reference creates dirs via FUSE/gRPC;
                    # HTTP POST with no body maps to mkdir here — but a
                    # zero-byte PUT means an EMPTY FILE, as everywhere)
                    from seaweedfs_tpu_torch.filer.entry import new_directory_entry

                    server.filer.create_entry(new_directory_entry(path))
                    return self._json({"name": path}, 201)
                try:
                    chunks = server._upload_bytes(
                        data,
                        filename=upload_filename or path.rsplit("/", 1)[-1],
                        mime=mime,
                        collection=q.get("collection", ""),
                        replication=q.get("replication", ""),
                        ttl=q.get("ttl", ""),
                    )
                except RuntimeError as e:
                    return self._json({"error": str(e)}, 500)
                now = int(time.time())
                entry = Entry(
                    full_path=path,
                    attr=Attr(
                        mtime=now,
                        crtime=now,
                        mime=mime,
                        replication=q.get("replication", ""),
                        collection=q.get("collection", ""),
                    ),
                    chunks=chunks,
                )
                server.filer.create_entry(entry)
                self._json({"name": entry.name, "size": len(data)}, 201)

            def do_DELETE(self):
                path, q = self._path_and_query()
                try:
                    server.filer.delete_entry(
                        path,
                        is_recursive=q.get("recursive") == "true",
                        delete_data=True,
                    )
                except EntryNotFound:
                    return self._json({"error": "not found"}, 404)
                except ValueError as e:
                    return self._json({"error": str(e)}, 409)
                self._reply(204)

            def _read_chunked_body(self, limit=1 << 30) -> bytes:
                pieces = []
                total = 0
                while True:
                    szline = self.rfile.readline(1026).strip()
                    try:
                        size = int(szline.split(b";")[0], 16)
                    except ValueError:
                        raise ValueError(f"bad chunk size {szline[:32]!r}")
                    if size == 0:
                        while True:  # trailers until blank line
                            t = self.rfile.readline(65537)
                            if t in (b"\r\n", b"\n", b""):
                                break
                        return b"".join(pieces)
                    total += size
                    if total > limit:
                        raise ValueError("chunked body too large")
                    piece = self.rfile.read(size)
                    if len(piece) != size:
                        raise ValueError("truncated chunk")
                    pieces.append(piece)
                    self.rfile.readline(3)  # CRLF after each chunk

            # the reference routes PUT through the same PostHandler
            # (filer_server_handlers.go:25-28)
            do_PUT = do_POST

        return Handler

    # ------------------------------------------------------------------
    def start(self) -> None:
        self.filer.start_deletion_loop()
        self._grpc_pool = futures.ThreadPoolExecutor(max_workers=16)
        self._grpc_server = grpc.server(self._grpc_pool)
        self._grpc_server.add_generic_rpc_handlers(
            (rpc.servicer_handler(rpc.FILER_SERVICE, rpc.FILER_METHODS, self),)
        )
        rpc.add_port(self._grpc_server, f"{self.host}:{self.grpc_port}")
        self._grpc_server.start()
        self._http_server = WeedHTTPServer(
            (self.host, self.port), self._http_handler_class()
        )
        # tracing plane: filer spans carry the gateway's trace onward to
        # the volume hops (assign/upload ride op.http_call, which
        # injects the header)
        self._http_server.trace_name = "filer"
        self._http_server.trace_node = f"{self.host}:{self.port}"
        # /metrics exposition via the mini loop (like S3/WebDAV): the
        # filer's UI always linked /metrics but its path router treated
        # it as a namespace lookup (404 on a fresh store) — the cluster
        # collector needs the real exposition. Tradeoff: a stored FILE
        # literally named /metrics is shadowed on GET, same contract as
        # the other gateways.
        self._http_server.gateway_metrics = True
        self._http_thread = threading.Thread(
            target=self._http_server.serve_forever, daemon=True
        )
        self._http_thread.start()
        # a serve loop that could not arm raises here, not later
        self._http_server.wait_armed()
        # telemetry plane: announce this gateway to the master so the
        # leader's collector scrapes it, and start the sampling profiler
        from seaweedfs_tpu_torch.telemetry import profiler
        from seaweedfs_tpu_torch.telemetry.announce import start_announce_loop

        self._profiling = profiler.ensure_started()
        self._announce = start_announce_loop(
            "filer", f"{self.host}:{self.port}", self.masters,
            interval=self.announce_interval,
        )

    def stop(self) -> None:
        """Stop serving. Every thread start() made has ended when this
        returns: the announce loop, the HTTP listener, the gRPC workers,
        the chunk-deletion loop (after one last flush) and this filer's
        hold on the sampling profiler; the store is closed."""
        if self._announce is not None:
            self._announce.stop_event.set()
            self._announce.join(timeout=10)
        if self._http_server:
            self._http_server.shutdown()
            self._http_server.server_close()
        if self._http_thread is not None:
            self._http_thread.join(timeout=10)
        if self._grpc_server:
            rpc.stop_server(self._grpc_server, self._grpc_pool)
        self.filer.stop()
        if self._profiling:
            from seaweedfs_tpu_torch.telemetry import profiler

            profiler.release()
            self._profiling = False
