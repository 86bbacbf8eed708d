"""WebDAV gateway over the filer.

Behavioral match of weed/server/webdav_server.go:44-93, which adapts
golang.org/x/net/webdav's FileSystem interface onto filer gRPC. With no
webdav library in this image the protocol layer is implemented
directly: OPTIONS, PROPFIND (Depth 0/1), MKCOL, GET/HEAD, PUT, DELETE,
MOVE, COPY with 207 multistatus XML — the verb set `cadaver`,
macOS Finder, and davfs2 need. Object bytes ride the filer HTTP path
(auto-chunking), metadata rides filer gRPC, same split as the S3
gateway.

The port of seaweedfs_tpu/webdav/webdav_server.py. The gateway holds no
codec and never touches the card: file bytes live on the volume servers
behind the filer, and a holder that lost shards decodes them. start()
returns once the serving loop is armed (it raises if the C loop cannot
arm), and stop() ends every thread start() made.
"""

from __future__ import annotations

import threading
import time
import urllib.error
import urllib.parse
import urllib.request
import xml.etree.ElementTree as ET

import grpc

from seaweedfs_tpu_torch import trace
from seaweedfs_tpu_torch.pb import filer_pb2 as fpb
from seaweedfs_tpu_torch.util.httpd import FastHandler, WeedHTTPServer
from seaweedfs_tpu_torch.pb import rpc

DAV_NS = "DAV:"


class WebDavServer:
    def __init__(
        self,
        filer: str,
        host: str = "127.0.0.1",
        port: int = 7333,
        root: str = "/",
        masters: list[str] | None = None,
        announce_interval: float = 10.0,
        reuse_port: bool = False,
        serve_idle_ms: int = 0,
        serve_max_reqs: int = 0,
        admission_rate: float = 0.0,
        admission_burst: float = 0.0,
        admission_inflight: int = 0,
        admission_procs: int = 1,
        admission_shm_path: str = "",
    ):
        self.filer = filer
        self.host = host
        self.port = port
        self.root = root.rstrip("/")
        # telemetry plane: masters to announce this gateway to so the
        # cluster collector can scrape it (empty = no announce)
        self.masters = list(masters or [])
        self.announce_interval = announce_interval
        # `webdav -serveProcs N`: SO_REUSEPORT accept-process group +
        # keep-alive knobs (docs/SERVING.md)
        self.reuse_port = reuse_port
        self.serve_idle_ms = serve_idle_ms
        self.serve_max_reqs = serve_max_reqs
        # QoS plane (docs/QOS.md): per-client admission control keyed
        # by remote address (WebDAV carries no access keys); budgets
        # split across the -serveProcs group like the S3 gateway's
        self.admission = None
        if admission_rate > 0 or admission_inflight > 0:
            from seaweedfs_tpu_torch.qos.admission import AdmissionController

            self.admission = AdmissionController(
                rate=admission_rate,
                burst=admission_burst,
                max_inflight=admission_inflight,
                procs=admission_procs,
                label="webdav",
                shm_path=admission_shm_path,
            )
        self._announce: threading.Thread | None = None
        self._http_server: WeedHTTPServer | None = None
        self._http_thread: threading.Thread | None = None
        self._profiling = False
        self._channel: grpc.Channel | None = None
        self._lock = threading.Lock()

    # ------------------------------------------------------------------
    def _stub(self):
        with self._lock:
            if self._channel is None:
                self._channel = rpc.dial(rpc.grpc_address(self.filer))
            return rpc.filer_stub(self._channel)

    def _full(self, dav_path: str) -> str:
        path = self.root + "/" + dav_path.strip("/")
        return path.rstrip("/") or "/"

    def _lookup(self, full_path: str):
        directory, _, name = full_path.rpartition("/")
        if not name:
            # the namespace root always exists as a collection
            return fpb.Entry(name="/", is_directory=True)
        try:
            return self._stub().LookupDirectoryEntry(
                fpb.LookupDirectoryEntryRequest(
                    directory=directory or "/", name=name
                )
            ).entry
        except grpc.RpcError:
            return None

    def _list(self, full_path: str):
        try:
            return [
                r.entry
                for r in self._stub().ListEntries(
                    fpb.ListEntriesRequest(directory=full_path, limit=10000)
                )
            ]
        except grpc.RpcError:
            return []

    def start(self) -> None:
        if self.reuse_port:
            from seaweedfs_tpu_torch.util.httpd import ReusePortWeedHTTPServer

            server_cls = ReusePortWeedHTTPServer
        else:
            server_cls = WeedHTTPServer
        self._http_server = server_cls(
            (self.host, self.port), self._handler_class()
        )
        self._http_server.serve_idle_ms = self.serve_idle_ms
        self._http_server.serve_max_reqs = self.serve_max_reqs
        # tracing + metrics plane: span per request, request counters/
        # histograms under "webdav", and /metrics exposition (the
        # gateway exposed nothing before)
        self._http_server.trace_name = "webdav"
        self._http_server.trace_node = f"{self.host}:{self.port}"
        self._http_server.gateway_metrics = True
        self._http_server.admission = self.admission
        self._http_thread = threading.Thread(
            target=self._http_server.serve_forever, daemon=True, name="webdav-http"
        )
        self._http_thread.start()
        # a serve loop that could not arm raises here, not later
        self._http_server.wait_armed()
        from seaweedfs_tpu_torch.telemetry import profiler
        from seaweedfs_tpu_torch.telemetry.announce import start_announce_loop

        self._profiling = profiler.ensure_started()
        self._announce = start_announce_loop(
            "webdav", f"{self.host}:{self.port}", self.masters,
            interval=self.announce_interval,
        )

    def stop(self) -> None:
        """Stop serving. Every thread start() made has ended when this
        returns: the announce loop, the HTTP listener and this gateway's
        hold on the sampling profiler; the filer channel is closed."""
        if self._announce is not None:
            self._announce.stop_event.set()
            self._announce.join(timeout=10)
        if self._http_server:
            self._http_server.shutdown()
            self._http_server.server_close()
        if self._http_thread is not None:
            self._http_thread.join(timeout=10)
        if self._channel is not None:
            self._channel.close()
        if self._profiling:
            from seaweedfs_tpu_torch.telemetry import profiler

            profiler.release()
            self._profiling = False

    # ------------------------------------------------------------------
    def _handler_class(self):
        server = self

        class Handler(FastHandler):
            # DAV verbs (PROPFIND/MKCOL/MOVE/...) ride the mini request
            # loop's dict dispatch exactly like GET/PUT — the loop's
            # do_* table is built from dir(handler), not a verb list

            def _send(self, status: int, body: bytes = b"", headers: dict | None = None):
                self.fast_reply(status, body, headers)

            def _dav_path(self) -> str:
                return urllib.parse.unquote(urllib.parse.urlparse(self.path).path)

            def _read_body(self) -> bytes:
                n = int(self.headers.get("Content-Length", "0") or "0")
                return self.rfile.read(n) if n else b""

            # ---------------- verbs ----------------
            def do_OPTIONS(self):
                self._send(
                    200,
                    headers={
                        "DAV": "1,2",
                        "MS-Author-Via": "DAV",
                        "Allow": "OPTIONS, PROPFIND, MKCOL, GET, HEAD, PUT, "
                        "DELETE, MOVE, COPY, PROPPATCH, LOCK, UNLOCK",
                    },
                )

            def do_PROPFIND(self):
                self._read_body()  # property filters: we always return the basic set
                dav = self._dav_path()
                full = server._full(dav)
                entry = server._lookup(full)
                if entry is None:
                    return self._send(404)
                depth = self.headers.get("Depth", "1")
                ms = ET.Element("{DAV:}multistatus")
                _add_response(ms, dav, entry)
                if depth != "0" and entry.is_directory:
                    base = dav.rstrip("/")
                    for child in server._list(full):
                        _add_response(ms, f"{base}/{child.name}", child)
                ET.register_namespace("D", DAV_NS)
                body = b'<?xml version="1.0" encoding="utf-8"?>' + ET.tostring(ms)
                self._send(
                    207, body, {"Content-Type": 'application/xml; charset="utf-8"'}
                )

            def do_PROPPATCH(self):
                self._read_body()
                # properties aren't persisted (the reference's webdav FS
                # ignores them too); reply success so clients proceed
                self._send(207, b'<?xml version="1.0"?><D:multistatus xmlns:D="DAV:"/>')

            def do_MKCOL(self):
                dav = self._dav_path()
                full = server._full(dav)
                if server._lookup(full) is not None:
                    return self._send(405)
                directory, _, name = full.rpartition("/")
                try:
                    server._stub().CreateEntry(
                        fpb.CreateEntryRequest(
                            directory=directory or "/",
                            entry=fpb.Entry(
                                name=name,
                                is_directory=True,
                                attributes=fpb.Attributes(
                                    mtime=int(time.time()), file_mode=0o40777
                                ),
                            ),
                        )
                    )
                except grpc.RpcError:
                    return self._send(409)
                self._send(201)

            def do_GET(self):
                dav = self._dav_path()
                full = server._full(dav)
                entry = server._lookup(full)
                if entry is None:
                    return self._send(404)
                if entry.is_directory:
                    names = "\n".join(e.name for e in server._list(full))
                    return self._send(
                        200, names.encode(), {"Content-Type": "text/plain"}
                    )
                req = urllib.request.Request(
                    f"http://{server.filer}{urllib.parse.quote(full)}",
                    # HEAD passes through as HEAD: the filer answers it
                    # from metadata with zero chunk IO, so size probes
                    # on multi-GB files never read the body
                    method=self.command,
                )
                trace.inject_request(req)
                rng = self.headers.get("Range")
                if rng:
                    # WebDAV clients (video players, resumable copies)
                    # issue ranged GETs; the filer serves them natively
                    req.add_header("Range", rng)
                try:
                    # weedlint: ignore[no-deadline] — one bounded 60 s hop to the local filer; ranged Request objects predate the pooled transport
                    with urllib.request.urlopen(req, timeout=60) as r:
                        data = b"" if self.command == "HEAD" else r.read()
                        mime = r.headers.get("Content-Type", "application/octet-stream")
                        headers = {"Content-Type": mime, "Accept-Ranges": "bytes"}
                        if r.status == 206:
                            headers["Content-Range"] = r.headers.get("Content-Range", "")
                        return self._send(r.status, data, headers)
                except urllib.error.HTTPError as e:
                    hdrs = {}
                    if e.code == 416 and e.headers.get("Content-Range"):
                        # the unsatisfiable-range reply must carry the
                        # real size or resumable clients cannot recover
                        hdrs["Content-Range"] = e.headers["Content-Range"]
                    return self._send(e.code, b"", hdrs)

            do_HEAD = do_GET

            def do_PUT(self):
                full = server._full(self._dav_path())
                body = self._read_body()
                req = urllib.request.Request(
                    f"http://{server.filer}{urllib.parse.quote(full)}",
                    data=body,
                    method="POST",
                )
                trace.inject_request(req)
                ct = self.headers.get("Content-Type")
                if ct:
                    req.add_header("Content-Type", ct)
                try:
                    # weedlint: ignore[no-deadline] — one bounded 60 s filer PUT hop; rides the same migration as the GET above
                    urllib.request.urlopen(req, timeout=60).close()
                except urllib.error.HTTPError as e:
                    return self._send(e.code)
                self._send(201)

            def do_DELETE(self):
                full = server._full(self._dav_path())
                entry = server._lookup(full)
                if entry is None:
                    return self._send(404)
                directory, _, name = full.rpartition("/")
                try:
                    server._stub().DeleteEntry(
                        fpb.DeleteEntryRequest(
                            directory=directory or "/",
                            name=name,
                            is_delete_data=True,
                            is_recursive=True,
                        )
                    )
                except grpc.RpcError:
                    return self._send(409)
                self._send(204)

            def do_MOVE(self):
                src = server._full(self._dav_path())
                dst_hdr = self.headers.get("Destination", "")
                dst = server._full(
                    urllib.parse.unquote(urllib.parse.urlparse(dst_hdr).path)
                )
                if server._lookup(src) is None:
                    return self._send(404)
                overwrote = server._lookup(dst) is not None
                sdir, _, sname = src.rpartition("/")
                ddir, _, dname = dst.rpartition("/")
                try:
                    server._stub().AtomicRenameEntry(
                        fpb.AtomicRenameEntryRequest(
                            old_directory=sdir or "/",
                            old_name=sname,
                            new_directory=ddir or "/",
                            new_name=dname,
                        )
                    )
                except grpc.RpcError:
                    return self._send(409)
                self._send(204 if overwrote else 201)

            def do_COPY(self):
                src = server._full(self._dav_path())
                dst_hdr = self.headers.get("Destination", "")
                dst = server._full(
                    urllib.parse.unquote(urllib.parse.urlparse(dst_hdr).path)
                )
                entry = server._lookup(src)
                if entry is None:
                    return self._send(404)
                if entry.is_directory:
                    return self._send(501)  # collection COPY: not supported
                overwrote = server._lookup(dst) is not None
                try:
                    # weedlint: ignore[no-deadline] — COPY source read, one bounded 60 s filer hop
                    with urllib.request.urlopen(
                        f"http://{server.filer}{urllib.parse.quote(src)}", timeout=60
                    ) as r:
                        data = r.read()
                        mime = r.headers.get("Content-Type", "")
                    req = urllib.request.Request(
                        f"http://{server.filer}{urllib.parse.quote(dst)}",
                        data=data,
                        method="POST",
                    )
                    trace.inject_request(req)
                    if mime:
                        req.add_header("Content-Type", mime)
                    # weedlint: ignore[no-deadline] — COPY destination write, one bounded 60 s filer hop
                    urllib.request.urlopen(req, timeout=60).close()
                except urllib.error.HTTPError as e:
                    return self._send(e.code)
                self._send(204 if overwrote else 201)

            def do_LOCK(self):
                # advertise-only locking (class 2 so clients write): hand
                # out an opaque token without server-side state
                token = f"opaquelocktoken:{int(time.time()*1000):x}"
                body = (
                    '<?xml version="1.0" encoding="utf-8"?>'
                    '<D:prop xmlns:D="DAV:"><D:lockdiscovery><D:activelock>'
                    "<D:locktype><D:write/></D:locktype>"
                    "<D:lockscope><D:exclusive/></D:lockscope>"
                    f"<D:locktoken><D:href>{token}</D:href></D:locktoken>"
                    "</D:activelock></D:lockdiscovery></D:prop>"
                ).encode()
                self._send(
                    200,
                    body,
                    {"Lock-Token": f"<{token}>", "Content-Type": "application/xml"},
                )

            def do_UNLOCK(self):
                self._send(204)

        return Handler





def _add_response(ms: ET.Element, href: str, entry) -> None:
    resp = ET.SubElement(ms, "{DAV:}response")
    is_dir = entry.is_directory
    ET.SubElement(resp, "{DAV:}href").text = urllib.parse.quote(
        href if not is_dir else href.rstrip("/") + "/"
    )
    propstat = ET.SubElement(resp, "{DAV:}propstat")
    prop = ET.SubElement(propstat, "{DAV:}prop")
    rtype = ET.SubElement(prop, "{DAV:}resourcetype")
    if is_dir:
        ET.SubElement(rtype, "{DAV:}collection")
    else:
        size = sum(c.size for c in entry.chunks)
        ET.SubElement(prop, "{DAV:}getcontentlength").text = str(size)
        mime = entry.attributes.mime or "application/octet-stream"
        ET.SubElement(prop, "{DAV:}getcontenttype").text = mime
    mtime = entry.attributes.mtime if entry.attributes else 0
    ET.SubElement(prop, "{DAV:}getlastmodified").text = time.strftime(
        "%a, %d %b %Y %H:%M:%S GMT", time.gmtime(mtime or 0)
    )
    ET.SubElement(prop, "{DAV:}displayname").text = entry.name
    ET.SubElement(propstat, "{DAV:}status").text = "HTTP/1.1 200 OK"
