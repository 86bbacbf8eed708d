"""S3-compatible gateway over the filer.

Behavioral match of weed/s3api/s3api_server.go:31-70 (route table) and
its handlers: buckets are directories under `/buckets` on the filer
(s3api_bucket_handlers.go), object bytes are proxied to the filer HTTP
server (s3api_object_handlers.go PutObjectHandler→putToFiler), metadata
ops ride the filer gRPC service, and multipart uploads stage parts in
`/buckets/<bucket>/.uploads/<uploadId>/` then splice every part's
chunks into one entry on complete (filer_multipart.go:56-120).

Route dispatch (the gorilla/mux table, s3api_server.go:42-79):
  HEAD   /b            HeadBucket           HEAD   /b/k  HeadObject
  PUT    /b            PutBucket            PUT    /b/k  PutObject | PutObjectPart(partNumber&uploadId) | CopyObject(X-Amz-Copy-Source)
  DELETE /b            DeleteBucket         DELETE /b/k  DeleteObject | AbortMultipartUpload(uploadId)
  GET    /             ListBuckets          GET    /b/k  GetObject | ListObjectParts(uploadId)
  GET    /b            ListObjectsV1 | ListObjectsV2(list-type=2) | ListMultipartUploads(uploads)
  POST   /b            DeleteMultipleObjects(delete)
  POST   /b/k          NewMultipartUpload(uploads) | CompleteMultipartUpload(uploadId)

The port of seaweedfs_tpu/s3api/s3api_server.py. The gateway holds no
codec and never touches the card: object bytes live on the volume
servers behind the filer, and a holder that lost shards decodes them.
start() returns once the serving loop is armed (it raises if the C loop
cannot arm), and stop() ends every thread start() made.
"""

from __future__ import annotations

import hashlib
import threading
import time
import urllib.error
import urllib.parse
import urllib.request
import uuid
import xml.etree.ElementTree as ET
from xml.sax.saxutils import escape

import grpc

from seaweedfs_tpu_torch import trace
from seaweedfs_tpu_torch.util import deadline as _deadline
from seaweedfs_tpu_torch.pb import filer_pb2 as fpb
from seaweedfs_tpu_torch.util.httpd import FastHandler, WeedHTTPServer
from seaweedfs_tpu_torch.pb import rpc
from seaweedfs_tpu_torch.s3api import auth as s3auth
from seaweedfs_tpu_torch.s3api import chunked_reader
from seaweedfs_tpu_torch.s3api.errors import S3Error, s3_error

S3_XMLNS = "http://s3.amazonaws.com/doc/2006-03-01/"
MAX_OBJECT_LIST_SIZE = 1000  # s3api_objects_list_handlers.go:21


class S3ApiServer:
    def __init__(
        self,
        filer: str,
        host: str = "127.0.0.1",
        port: int = 8333,
        buckets_path: str = "/buckets",
        iam: s3auth.IdentityAccessManagement | None = None,
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
        self.buckets_path = buckets_path.rstrip("/")
        self.iam = iam or s3auth.IdentityAccessManagement()
        # telemetry plane: masters to announce this gateway to (the S3
        # gateway only knows its filer; the operator passes -master so
        # the cluster collector can scrape it)
        self.masters = list(masters or [])
        self.announce_interval = announce_interval
        # `s3 -serveProcs N`: every process of the group binds the port
        # with SO_REUSEPORT so the kernel spreads accepted connections
        # (docs/SERVING.md); the keep-alive knobs ride to the loop
        self.reuse_port = reuse_port
        self.serve_idle_ms = serve_idle_ms
        self.serve_max_reqs = serve_max_reqs
        # QoS plane (docs/QOS.md): per-client admission control, keyed
        # by S3 access key when the request is signed (else remote
        # addr). `admission_procs` = the -serveProcs group size, so each
        # sibling process enforces its share of the global budget.
        self.admission = None
        if admission_rate > 0 or admission_inflight > 0:
            from seaweedfs_tpu_torch.qos.admission import AdmissionController

            self.admission = AdmissionController(
                rate=admission_rate,
                burst=admission_burst,
                max_inflight=admission_inflight,
                procs=admission_procs,
                label="s3",
                shm_path=admission_shm_path,
            )
        self._announce: threading.Thread | None = None
        self._http_server: WeedHTTPServer | None = None
        self._http_thread: threading.Thread | None = None
        self._profiling = False
        self._channel: grpc.Channel | None = None
        self._channel_lock = threading.Lock()

    # ------------------------------------------------------------------
    # filer access
    def _stub(self):
        with self._channel_lock:
            if self._channel is None:
                self._channel = rpc.dial(rpc.grpc_address(self.filer))
            return rpc.filer_stub(self._channel)

    def _lookup(self, directory: str, name: str):
        try:
            return self._stub().LookupDirectoryEntry(
                fpb.LookupDirectoryEntryRequest(directory=directory, name=name)
            ).entry
        except grpc.RpcError:
            return None

    def _mkdir(self, parent: str, name: str, extended: dict | None = None) -> None:
        entry = fpb.Entry(
            name=name,
            is_directory=True,
            attributes=fpb.Attributes(mtime=int(time.time()), file_mode=0o40777),
        )
        for k, v in (extended or {}).items():
            entry.extended[k] = v
        self._stub().CreateEntry(fpb.CreateEntryRequest(directory=parent, entry=entry))

    def _mkfile(self, parent: str, name: str, chunks, mime: str = "") -> None:
        entry = fpb.Entry(
            name=name,
            is_directory=False,
            chunks=chunks,
            attributes=fpb.Attributes(
                mtime=int(time.time()), file_mode=0o660, mime=mime
            ),
        )
        self._stub().CreateEntry(fpb.CreateEntryRequest(directory=parent, entry=entry))

    def _list(self, directory: str, prefix: str = "", start: str = "",
              inclusive: bool = False, limit: int = MAX_OBJECT_LIST_SIZE):
        try:
            return [
                resp.entry
                for resp in self._stub().ListEntries(
                    fpb.ListEntriesRequest(
                        directory=directory,
                        prefix=prefix,
                        start_from_file_name=start,
                        inclusive_start_from=inclusive,
                        limit=limit,
                    )
                )
            ]
        except grpc.RpcError:
            return []

    def _rm(self, directory: str, name: str, delete_data: bool = True) -> None:
        try:
            self._stub().DeleteEntry(
                fpb.DeleteEntryRequest(
                    directory=directory,
                    name=name,
                    is_delete_data=delete_data,
                    is_recursive=True,
                )
            )
        except grpc.RpcError:
            pass

    def _filer_url(self, *segments: str) -> str:
        path = "/".join(urllib.parse.quote(s) for s in segments if s)
        return f"http://{self.filer}/{path}"

    def _filer_hop_timeout(self, req) -> float:
        """Deadline plane (docs/CHAOS.md): the gateway→filer hop runs
        under the request's ambient budget — the X-Weed-Deadline header
        rides along (the filer 504-fast-rejects expired work) and the
        socket timeout shrinks to the remaining budget, so a
        partitioned filer costs a bounded failure, not a 60 s park.
        Deadline-less requests keep the fixed 60 s cap."""
        dl = _deadline.effective(None)
        if dl is None:
            return 60.0
        req.add_header(_deadline.DEADLINE_HEADER, dl.header_value())
        try:
            return dl.cap(60.0)
        except _deadline.DeadlineExceeded:
            # budget spent mid-request (body read + SigV4 check ate
            # it): answer a proper S3 error — letting the TimeoutError
            # propagate would be swallowed at the connection loop and
            # close the socket with no response at all
            raise s3_error("RequestTimeout") from None

    def _put_to_filer(self, path_segments: list[str], body: bytes, mime: str) -> None:
        """Store object bytes through the filer HTTP write path (which
        auto-chunks) — the putToFiler proxy in the reference."""
        req = urllib.request.Request(
            self._filer_url(*path_segments), data=body, method="POST"
        )
        if mime:
            req.add_header("Content-Type", mime)
        trace.inject_request(req)  # gateway→filer hop, same trace
        # weedlint: ignore[no-deadline] — deadline-aware via _filer_hop_timeout; streaming Request bodies don't fit the pooled transport yet
        with urllib.request.urlopen(
            req, timeout=self._filer_hop_timeout(req)
        ) as r:
            if r.status >= 300:
                raise s3_error("InternalError")

    def _get_from_filer(self, path_segments: list[str]) -> tuple[bytes, str]:
        try:
            req = urllib.request.Request(self._filer_url(*path_segments))
            trace.inject_request(req)
            # weedlint: ignore[no-deadline] — deadline-aware via _filer_hop_timeout; migrating GETs to http_call rides with the PUT path above
            with urllib.request.urlopen(
                req, timeout=self._filer_hop_timeout(req)
            ) as r:
                return r.read(), r.headers.get("Content-Type", "")
        except urllib.error.HTTPError as e:
            if e.code == 404:
                raise s3_error("NoSuchKey") from None
            raise s3_error("InternalError") from None

    def _uploads_folder(self, bucket: str) -> str:
        # genUploadsFolder (s3api_object_multipart_handlers.go:219)
        return f"{self.buckets_path}/{bucket}/.uploads"

    # ------------------------------------------------------------------
    # lifecycle
    def start(self) -> None:
        handler = self._handler_class()
        if self.reuse_port:
            from seaweedfs_tpu_torch.util.httpd import ReusePortWeedHTTPServer

            server_cls = ReusePortWeedHTTPServer
        else:
            server_cls = WeedHTTPServer
        self._http_server = server_cls((self.host, self.port), handler)
        self._http_server.serve_idle_ms = self.serve_idle_ms
        self._http_server.serve_max_reqs = self.serve_max_reqs
        # tracing + metrics plane: span per request in the mini loop,
        # request counters/histograms under the "s3" label, and the
        # /metrics exposition the gateway previously lacked (served by
        # the loop — exact-path GET /metrics, so bucket routing keeps
        # every other path)
        self._http_server.trace_name = "s3"
        self._http_server.trace_node = f"{self.host}:{self.port}"
        self._http_server.gateway_metrics = True
        # the S3 gateway is the one auth-fronted daemon: with
        # identities configured, /debug/* and /metrics would otherwise
        # leak object keys/latencies to unauthenticated peers (and
        # shadow a bucket literally named "debug"/"metrics"), so only
        # loopback operators keep the unauthenticated surface
        self._http_server.debug_gate = (
            lambda h: not self.iam.is_enabled
            or h.client_address[0] in ("127.0.0.1", "::1")
        )
        self._http_server.admission = self.admission
        self._http_thread = threading.Thread(
            target=self._http_server.serve_forever, daemon=True, name="s3-http"
        )
        self._http_thread.start()
        # a serve loop that could not arm raises here, not later
        self._http_server.wait_armed()
        from seaweedfs_tpu_torch.telemetry import profiler
        from seaweedfs_tpu_torch.telemetry.announce import start_announce_loop

        self._profiling = profiler.ensure_started()
        self._announce = start_announce_loop(
            "s3", f"{self.host}:{self.port}", self.masters,
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
            # rides the util/httpd mini request loop like every other
            # serving path (one-buffer head parse, FastHeaders, dict
            # dispatch, keep-alive semantics, fast_reply one-write
            # responses) — the S3 data path no longer pays the stdlib
            # email-parser/send_header-per-line overhead the volume
            # server shed two rounds ago

            # ---------- plumbing ----------
            def _send(self, status: int, body: bytes = b"", headers: dict | None = None):
                out = {k: v for k, v in (headers or {}).items() if v}
                self.fast_reply(status, body, out or None)

            def _send_xml(self, root: ET.Element, status: int = 200):
                body = b'<?xml version="1.0" encoding="UTF-8"?>' + ET.tostring(root)
                self._send(status, body, {"Content-Type": "application/xml"})

            def _send_error(self, err: S3Error):
                self._send(
                    err.status,
                    err.to_xml(resource=self.path),
                    {"Content-Type": "application/xml"},
                )

            def _route(self):
                url = urllib.parse.urlparse(self.path)
                raw = urllib.parse.unquote(url.path)
                query = urllib.parse.parse_qs(url.query, keep_blank_values=True)
                parts = raw.lstrip("/").split("/", 1)
                bucket = parts[0]
                key = parts[1] if len(parts) > 1 else ""
                return bucket, key, query, url.path

            def _read_body(self) -> bytes:
                length = int(self.headers.get("Content-Length", "0") or "0")
                return self.rfile.read(length) if length else b""

            def _authenticate(self, body: bytes | None):
                url = urllib.parse.urlparse(self.path)
                query = urllib.parse.parse_qs(url.query, keep_blank_values=True)
                server.iam.authenticate(
                    self.command,
                    urllib.parse.unquote(url.path),
                    query,
                    self.headers,
                    body,
                )

            # ---------- verbs ----------
            def do_GET(self):
                try:
                    bucket, key, query, _ = self._route()
                    self._authenticate(b"")
                    if not bucket:
                        return self._list_buckets()
                    if key:
                        if "uploadId" in query:
                            return self._list_object_parts(bucket, key, query)
                        return self._get_object(bucket, key)
                    if "uploads" in query:
                        return self._list_multipart_uploads(bucket)
                    return self._list_objects(bucket, query)
                except S3Error as e:
                    self._send_error(e)

            def do_HEAD(self):
                try:
                    bucket, key, query, _ = self._route()
                    self._authenticate(b"")
                    if key:
                        return self._head_object(bucket, key)
                    return self._head_bucket(bucket)
                except S3Error as e:
                    self._send_error(e)

            def do_PUT(self):
                try:
                    bucket, key, query, _ = self._route()
                    body = self._read_body()
                    sha_hdr = self.headers.get("x-amz-content-sha256", "")
                    if sha_hdr == s3auth.STREAMING_PAYLOAD:
                        # Verify the header V4 signature (method, path,
                        # headers, date — payload hash is the STREAMING
                        # sentinel) BEFORE trusting the seed signature
                        # the per-chunk signatures chain from.
                        self._authenticate(None)
                        body = self._decode_streaming(body)
                    else:
                        self._authenticate(body)
                    if not key:
                        return self._put_bucket(bucket)
                    if "partNumber" in query and "uploadId" in query:
                        return self._put_object_part(bucket, key, query, body)
                    if self.headers.get("X-Amz-Copy-Source"):
                        return self._copy_object(bucket, key)
                    return self._put_object(bucket, key, body)
                except S3Error as e:
                    self._send_error(e)

            def do_POST(self):
                try:
                    bucket, key, query, _ = self._route()
                    body = self._read_body()
                    self._authenticate(body)
                    if key and "uploads" in query:
                        return self._new_multipart_upload(bucket, key)
                    if key and "uploadId" in query:
                        return self._complete_multipart_upload(bucket, key, query, body)
                    if "delete" in query:
                        return self._delete_multiple_objects(bucket, body)
                    raise s3_error("NotImplemented")
                except S3Error as e:
                    self._send_error(e)

            def do_DELETE(self):
                try:
                    bucket, key, query, _ = self._route()
                    self._authenticate(b"")
                    if key and "uploadId" in query:
                        return self._abort_multipart_upload(bucket, key, query)
                    if key:
                        return self._delete_object(bucket, key)
                    return self._delete_bucket(bucket)
                except S3Error as e:
                    self._send_error(e)

            # ---------- streaming sigv4 ----------
            def _decode_streaming(self, raw: bytes) -> bytes:
                import io

                if server.iam.is_enabled:
                    url = urllib.parse.urlparse(self.path)
                    query = urllib.parse.parse_qs(url.query, keep_blank_values=True)
                    key, seed, amz_date, scope = server.iam.seed_signature(
                        self.command,
                        urllib.parse.unquote(url.path),
                        query,
                        self.headers,
                    )
                    try:
                        return chunked_reader.decode_chunked_payload(
                            io.BytesIO(raw),
                            signing_key=key,
                            seed_signature=seed,
                            amz_date=amz_date,
                            scope=scope,
                        )
                    except chunked_reader.ChunkSignatureMismatch:
                        raise s3_error("SignatureDoesNotMatch") from None
                return chunked_reader.decode_chunked_payload(io.BytesIO(raw))

            # ---------- buckets ----------
            def _list_buckets(self):
                entries = server._list(server.buckets_path)
                root = ET.Element("ListAllMyBucketsResult", xmlns=S3_XMLNS)
                owner = ET.SubElement(root, "Owner")
                ET.SubElement(owner, "ID").text = ""
                buckets = ET.SubElement(root, "Buckets")
                for e in entries:
                    if not e.is_directory:
                        continue
                    b = ET.SubElement(buckets, "Bucket")
                    ET.SubElement(b, "Name").text = e.name
                    ET.SubElement(b, "CreationDate").text = _iso(e.attributes.mtime)
                self._send_xml(root)

            def _put_bucket(self, bucket: str):
                if not _valid_bucket_name(bucket):
                    raise s3_error("InvalidBucketName")
                if server._lookup(server.buckets_path, bucket) is not None:
                    raise s3_error("BucketAlreadyExists")
                server._mkdir(server.buckets_path, bucket)
                self._send(200, headers={"Location": f"/{bucket}"})

            def _head_bucket(self, bucket: str):
                if server._lookup(server.buckets_path, bucket) is None:
                    raise s3_error("NoSuchBucket")
                self._send(200)

            def _delete_bucket(self, bucket: str):
                if server._lookup(server.buckets_path, bucket) is None:
                    raise s3_error("NoSuchBucket")
                # the reference deletes the whole collection then the dir
                # (s3api_bucket_handlers.go DeleteBucketHandler)
                try:
                    server._stub().DeleteCollection(
                        fpb.DeleteCollectionRequest(collection=bucket)
                    )
                except grpc.RpcError:
                    pass
                server._rm(server.buckets_path, bucket, delete_data=False)
                self._send(204)

            # ---------- objects ----------
            def _put_object(self, bucket: str, key: str, body: bytes):
                if server._lookup(server.buckets_path, bucket) is None:
                    raise s3_error("NoSuchBucket")
                mime = self.headers.get("Content-Type", "")
                server._put_to_filer(
                    [server.buckets_path.lstrip("/"), bucket] + key.split("/"),
                    body,
                    mime,
                )
                etag = hashlib.md5(body).hexdigest()
                self._send(200, headers={"ETag": f'"{etag}"'})

            def _copy_object(self, bucket: str, key: str):
                src = urllib.parse.unquote(self.headers["X-Amz-Copy-Source"])
                src = src.lstrip("/")
                src_bucket, _, src_key = src.partition("/")
                data, mime = server._get_from_filer(
                    [server.buckets_path.lstrip("/"), src_bucket] + src_key.split("/")
                )
                server._put_to_filer(
                    [server.buckets_path.lstrip("/"), bucket] + key.split("/"),
                    data,
                    mime,
                )
                root = ET.Element("CopyObjectResult", xmlns=S3_XMLNS)
                ET.SubElement(root, "ETag").text = f'"{hashlib.md5(data).hexdigest()}"'
                ET.SubElement(root, "LastModified").text = _iso(int(time.time()))
                self._send_xml(root)

            def _get_object(self, bucket: str, key: str):
                data, mime = server._get_from_filer(
                    [server.buckets_path.lstrip("/"), bucket] + key.split("/")
                )
                headers = {
                    "Content-Type": mime or "application/octet-stream",
                    "ETag": f'"{hashlib.md5(data).hexdigest()}"',
                    "Accept-Ranges": "bytes",
                }
                from seaweedfs_tpu_torch.util.http_range import (
                    RangeNotSatisfiable,
                    parse_range,
                )

                total = len(data)
                try:
                    span = parse_range(self.headers.get("Range", ""), total)
                except RangeNotSatisfiable:
                    self._send(416, b"", {"Content-Range": f"bytes */{total}"})
                    return
                if span is not None:
                    start, end = span
                    headers["Content-Range"] = f"bytes {start}-{end}/{total}"
                    self._send(206, data[start : end + 1], headers)
                    return
                self._send(200, data, headers)

            def _head_object(self, bucket: str, key: str):
                directory, _, name = f"{server.buckets_path}/{bucket}/{key}".rpartition("/")
                entry = server._lookup(directory, name)
                if entry is None or entry.is_directory:
                    raise s3_error("NoSuchKey")
                size = sum(c.size for c in entry.chunks)
                self._send(
                    200,
                    headers={
                        "Content-Type": entry.attributes.mime
                        or "application/octet-stream",
                        "Content-Length-Hint": str(size),
                        "Last-Modified": _http_date(entry.attributes.mtime),
                    },
                )

            def _delete_object(self, bucket: str, key: str):
                directory, _, name = f"{server.buckets_path}/{bucket}/{key}".rpartition("/")
                server._rm(directory, name, delete_data=True)
                self._send(204)

            def _delete_multiple_objects(self, bucket: str, body: bytes):
                try:
                    root = ET.fromstring(body)
                except ET.ParseError:
                    raise s3_error("MalformedXML") from None
                deleted, errors = [], []
                ns = ""
                if root.tag.startswith("{"):
                    ns = root.tag[: root.tag.index("}") + 1]
                for obj in root.findall(f"{ns}Object"):
                    key_el = obj.find(f"{ns}Key")
                    if key_el is None or not key_el.text:
                        continue
                    key = key_el.text
                    directory, _, name = (
                        f"{server.buckets_path}/{bucket}/{key}".rpartition("/")
                    )
                    server._rm(directory, name, delete_data=True)
                    deleted.append(key)
                out = ET.Element("DeleteResult", xmlns=S3_XMLNS)
                for key in deleted:
                    d = ET.SubElement(out, "Deleted")
                    ET.SubElement(d, "Key").text = key
                self._send_xml(out)

            # ---------- listing ----------
            def _list_objects(self, bucket: str, query: dict):
                if server._lookup(server.buckets_path, bucket) is None:
                    raise s3_error("NoSuchBucket")
                v2 = query.get("list-type", [""])[0] == "2"
                prefix = query.get("prefix", [""])[0]
                delimiter = query.get("delimiter", [""])[0]
                if v2:
                    marker = query.get("continuation-token", [""])[0] or query.get(
                        "start-after", [""]
                    )[0]
                else:
                    marker = query.get("marker", [""])[0]
                try:
                    max_keys = int(query.get("max-keys", ["1000"])[0])
                except ValueError:
                    raise s3_error("InvalidMaxKeys") from None
                if max_keys < 0:
                    raise s3_error("InvalidMaxKeys")
                if delimiter not in ("", "/"):
                    raise s3_error("NotImplemented")

                # split the prefix into directory part + entry-name prefix
                # (listFilerEntries, s3api_objects_list_handlers.go:92-100)
                slash = prefix.rfind("/")
                dir_part = prefix[: slash + 1] if slash >= 0 else ""
                name_prefix = prefix[slash + 1:] if slash >= 0 else prefix
                directory = f"{server.buckets_path}/{bucket}"
                if dir_part:
                    directory += "/" + dir_part.rstrip("/")
                rel_marker = marker[len(dir_part):] if marker.startswith(dir_part) else marker

                limit = min(max_keys, MAX_OBJECT_LIST_SIZE)
                contents, common = [], []
                keys = []
                last = ""
                truncated = False
                if delimiter == "/":
                    entries = server._list(
                        directory,
                        prefix=name_prefix,
                        start=rel_marker,
                        inclusive=False,
                        limit=limit + 1,
                    )
                    truncated = len(entries) > max_keys
                    entries = entries[:max_keys]
                    for e in entries:
                        last = f"{dir_part}{e.name}"
                        if e.is_directory:
                            if e.name != ".uploads":
                                common.append(f"{dir_part}{e.name}/")
                        else:
                            contents.append(e)
                            keys.append(last)
                else:
                    # flat listing: recurse into subdirectories so nested
                    # keys appear as Contents (S3 semantics when no
                    # delimiter is given)
                    def walk(dirpath, rel):
                        nonlocal truncated
                        sub = server._list(
                            dirpath,
                            prefix=name_prefix if rel == dir_part else "",
                            limit=MAX_OBJECT_LIST_SIZE + 1,
                        )
                        for e in sub:
                            if len(contents) > limit:
                                truncated = True
                                return
                            k = f"{rel}{e.name}"
                            if e.is_directory:
                                if e.name == ".uploads" and rel == "":
                                    continue
                                # prune subtrees wholly <= marker
                                if marker and not (
                                    f"{k}/" > marker
                                    or marker.startswith(f"{k}/")
                                ):
                                    continue
                                walk(f"{dirpath}/{e.name}", f"{k}/")
                            elif k > marker:
                                contents.append(e)
                                keys.append(k)

                    walk(directory, dir_part)
                    truncated = truncated or len(contents) > limit
                    contents = contents[:limit]
                    keys = keys[:limit]
                    if keys:
                        last = keys[-1]

                root = ET.Element("ListBucketResult", xmlns=S3_XMLNS)
                ET.SubElement(root, "Name").text = bucket
                ET.SubElement(root, "Prefix").text = prefix
                ET.SubElement(root, "Marker").text = marker
                ET.SubElement(root, "NextMarker").text = last if truncated else ""
                ET.SubElement(root, "MaxKeys").text = str(max_keys)
                if delimiter:
                    ET.SubElement(root, "Delimiter").text = delimiter
                ET.SubElement(root, "IsTruncated").text = (
                    "true" if truncated else "false"
                )
                if v2:
                    ET.SubElement(root, "KeyCount").text = str(len(contents))
                    if truncated:
                        ET.SubElement(root, "NextContinuationToken").text = last
                for e, full_key in zip(contents, keys):
                    c = ET.SubElement(root, "Contents")
                    ET.SubElement(c, "Key").text = full_key
                    ET.SubElement(c, "LastModified").text = _iso(e.attributes.mtime)
                    etag = e.chunks[0].e_tag if len(e.chunks) == 1 else ""
                    ET.SubElement(c, "ETag").text = f'"{etag}"'
                    ET.SubElement(c, "Size").text = str(
                        sum(ch.size for ch in e.chunks)
                    )
                    ET.SubElement(c, "StorageClass").text = "STANDARD"
                for p in common:
                    cp = ET.SubElement(root, "CommonPrefixes")
                    ET.SubElement(cp, "Prefix").text = p
                self._send_xml(root)

            # ---------- multipart ----------
            def _new_multipart_upload(self, bucket: str, key: str):
                upload_id = str(uuid.uuid4())
                # parent dirs (.../.uploads) auto-create on the filer side
                server._mkdir(
                    server._uploads_folder(bucket),
                    upload_id,
                    extended={"key": key.encode()},
                )
                root = ET.Element("InitiateMultipartUploadResult", xmlns=S3_XMLNS)
                ET.SubElement(root, "Bucket").text = bucket
                ET.SubElement(root, "Key").text = key
                ET.SubElement(root, "UploadId").text = upload_id
                self._send_xml(root)

            def _put_object_part(self, bucket, key, query, body):
                upload_id = query["uploadId"][0]
                try:
                    part_num = int(query["partNumber"][0])
                except ValueError:
                    raise s3_error("InvalidArgument") from None
                if not 1 <= part_num <= 10000:
                    raise s3_error("InvalidArgument")
                if server._lookup(server._uploads_folder(bucket), upload_id) is None:
                    raise s3_error("NoSuchUpload")
                server._put_to_filer(
                    [
                        server.buckets_path.lstrip("/"),
                        bucket,
                        ".uploads",
                        upload_id,
                        f"{part_num:04d}.part",
                    ],
                    body,
                    "application/octet-stream",
                )
                etag = hashlib.md5(body).hexdigest()
                # remember the md5 on the staged entry so complete can
                # validate the client's part manifest (the chunk e_tag
                # the volume assigns is a needle etag, not this md5)
                part_entry = server._lookup(
                    f"{server._uploads_folder(bucket)}/{upload_id}",
                    f"{part_num:04d}.part",
                )
                if part_entry is not None:
                    part_entry.extended["s3-md5"] = etag.encode()
                    try:
                        server._stub().UpdateEntry(
                            fpb.UpdateEntryRequest(
                                directory=(
                                    f"{server._uploads_folder(bucket)}"
                                    f"/{upload_id}"
                                ),
                                entry=part_entry,
                            )
                        )
                    except grpc.RpcError:
                        pass  # validation degrades to existence-only
                self._send(200, headers={"ETag": f'"{etag}"'})

            def _complete_multipart_upload(self, bucket, key, query, body):
                upload_id = query["uploadId"][0]
                upload_dir = f"{server._uploads_folder(bucket)}/{upload_id}"
                entries = server._list(upload_dir)
                if not entries:
                    raise s3_error("NoSuchUpload")
                # splice every part's chunks into one chunk list at
                # running offsets (filer_multipart.go:67-84)
                # numeric part order — lexical sort would splice part
                # 10000 ("10000.part") between 1000 and 1001
                parts = [
                    e for e in entries
                    if e.name.endswith(".part") and not e.is_directory
                ]
                manifest = _parse_complete_body(body)
                if manifest is not None:
                    # client sent the CompleteMultipartUpload manifest:
                    # validate it like real S3 before splicing —
                    # ascending part order (InvalidPartOrder), every
                    # listed part staged with a matching ETag
                    # (InvalidPart) — so a client that lost a part PUT
                    # gets a typed error, not a silently short object
                    if [n for n, _ in manifest] != sorted(
                        n for n, _ in manifest
                    ):
                        raise s3_error("InvalidPartOrder")
                    staged = {int(e.name[:-5]): e for e in parts}
                    chosen = []
                    for num, etag in manifest:
                        entry = staged.get(num)
                        if entry is None:
                            raise s3_error("InvalidPart")
                        if etag:
                            want = etag.strip('"')
                            have = _entry_part_etag(entry)
                            if have is not None and want != have:
                                raise s3_error("InvalidPart")
                        chosen.append(entry)
                    parts = chosen
                final_chunks = []
                offset = 0
                for entry in sorted(parts, key=lambda e: int(e.name[:-5])):
                    for chunk in entry.chunks:
                        final_chunks.append(
                            fpb.FileChunk(
                                fid=chunk.fid,
                                offset=offset,
                                size=chunk.size,
                                mtime=chunk.mtime,
                                e_tag=chunk.e_tag,
                            )
                        )
                        offset += chunk.size
                dir_name = f"{server.buckets_path}/{bucket}"
                entry_name = key
                if "/" in key:
                    sub, _, entry_name = key.rpartition("/")
                    dir_name = f"{dir_name}/{sub}"
                server._mkfile(dir_name, entry_name, final_chunks)
                # drop the staging dir but keep the part chunks alive —
                # the final entry references them
                server._rm(
                    server._uploads_folder(bucket), upload_id, delete_data=False
                )
                root = ET.Element("CompleteMultipartUploadResult", xmlns=S3_XMLNS)
                ET.SubElement(root, "Location").text = (
                    f"http://{server.filer}{dir_name}/{entry_name}"
                )
                ET.SubElement(root, "Bucket").text = bucket
                ET.SubElement(root, "Key").text = key
                ET.SubElement(root, "ETag").text = f'"{_chunks_etag(final_chunks)}"'
                self._send_xml(root)

            def _abort_multipart_upload(self, bucket, key, query):
                upload_id = query["uploadId"][0]
                if server._lookup(server._uploads_folder(bucket), upload_id) is None:
                    # unknown (or already aborted/completed) upload id
                    # gets the typed error, not a silent 204
                    raise s3_error("NoSuchUpload")
                # delete_data=True: the staged part chunks are orphans
                # once the staging dir goes — abort must reclaim them,
                # not leak volume space until vacuum
                server._rm(server._uploads_folder(bucket), upload_id, delete_data=True)
                self._send(204)

            def _list_multipart_uploads(self, bucket):
                uploads = server._list(server._uploads_folder(bucket))
                root = ET.Element("ListMultipartUploadsResult", xmlns=S3_XMLNS)
                ET.SubElement(root, "Bucket").text = bucket
                for u in uploads:
                    if not u.is_directory:
                        continue
                    el = ET.SubElement(root, "Upload")
                    ET.SubElement(el, "UploadId").text = u.name
                    key = u.extended.get("key", b"").decode()
                    ET.SubElement(el, "Key").text = key
                self._send_xml(root)

            def _list_object_parts(self, bucket, key, query):
                upload_id = query["uploadId"][0]
                upload_dir = f"{server._uploads_folder(bucket)}/{upload_id}"
                entries = server._list(upload_dir)
                if server._lookup(server._uploads_folder(bucket), upload_id) is None:
                    raise s3_error("NoSuchUpload")
                root = ET.Element("ListPartsResult", xmlns=S3_XMLNS)
                ET.SubElement(root, "Bucket").text = bucket
                ET.SubElement(root, "Key").text = key
                ET.SubElement(root, "UploadId").text = upload_id
                parts = [e for e in entries if e.name.endswith(".part")]
                for entry in sorted(parts, key=lambda e: int(e.name[:-5])):
                    p = ET.SubElement(root, "Part")
                    ET.SubElement(p, "PartNumber").text = str(
                        int(entry.name[:-5])
                    )
                    ET.SubElement(p, "LastModified").text = _iso(entry.attributes.mtime)
                    ET.SubElement(p, "Size").text = str(
                        sum(c.size for c in entry.chunks)
                    )
                self._send_xml(root)

        return Handler


# ----------------------------------------------------------------------
def _iso(epoch_sec: int) -> str:
    return time.strftime("%Y-%m-%dT%H:%M:%SZ", time.gmtime(epoch_sec or 0))


def _http_date(epoch_sec: int) -> str:
    return time.strftime(
        "%a, %d %b %Y %H:%M:%S GMT", time.gmtime(epoch_sec or 0)
    )


def _parse_complete_body(body: bytes) -> list[tuple[int, str]] | None:
    """Parse a CompleteMultipartUpload request body into
    [(part_number, etag), ...] in document order, or None when the
    client sent no manifest (legacy callers: assemble all staged
    parts). A malformed manifest is a malformed request."""
    if not body or not body.strip():
        return None
    try:
        root = ET.fromstring(body)
    except ET.ParseError:
        raise s3_error("MalformedXML") from None
    out: list[tuple[int, str]] = []
    for part in root.iter():
        if not part.tag.endswith("Part"):
            continue
        num, etag = None, ""
        for child in part:
            if child.tag.endswith("PartNumber"):
                try:
                    num = int((child.text or "").strip())
                except ValueError:
                    raise s3_error("MalformedXML") from None
            elif child.tag.endswith("ETag"):
                etag = (child.text or "").strip()
        if num is not None:
            out.append((num, etag))
    return out or None


def _entry_part_etag(entry) -> str | None:
    """The md5 ETag the part PUT responded with, recorded on the
    staged entry; None if the UpdateEntry that records it was lost
    (validation then degrades to part existence + order)."""
    raw = entry.extended.get("s3-md5", b"")
    return raw.decode() if raw else None


def _chunks_etag(chunks) -> str:
    h = hashlib.md5()
    for c in chunks:
        h.update(c.e_tag.encode() or c.fid.encode())
    return f"{h.hexdigest()}-{len(chunks)}"


def _valid_bucket_name(name: str) -> bool:
    if not 3 <= len(name) <= 63:
        return False
    return all(c.islower() or c.isdigit() or c in "-." for c in name) and (
        name[0].isalnum() and name[-1].isalnum()
    )
