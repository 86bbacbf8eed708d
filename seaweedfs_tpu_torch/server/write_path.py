"""The shared blob write path: request → Needle, replica fan-out, and
the write auth gate.

The volume server's POST handler builds needles here with the exact
semantics of the reference — multipart forms (needle.go:85 ParseUpload),
mime/name flags, JPEG orientation fixing, transparent + pre-gzipped
compression, chunk-manifest flag, Seaweed-* pairs, ts=/ttl= params —
and fans each write out to the replica peers the master names
(store_replicate.go:44-80), all-or-error. The reference's one-pass C
POST loop (native/post.c) waits for ROADMAP item 8, and the
hinted-handoff seam of its fan-out for item 10.
"""

from __future__ import annotations

import json
import os
import time

from seaweedfs_tpu_torch.storage.file_id import FileId
from seaweedfs_tpu_torch.storage.needle import Needle

# The write-path stage names the volume.post span carries, identical to
# the reference's C hot loop and Python path (docs/TRACING.md).
WRITE_STAGES = ("parse", "assemble", "crc", "pwrite", "reply")


def build_upload_needle(
    fid: FileId,
    q: dict,
    body: bytes,
    headers,
    url_filename: str = "",
    fix_jpg_orientation: bool = False,
    stages: dict | None = None,
) -> tuple[Needle | None, str, str | None]:
    """(needle, filename, error): error is a client-facing 400 message.

    `headers` is any case-insensitive mapping with .get and .items
    (FastHeaders on the data plane). A `stages` dict collects the
    tracing plane's "parse" (payload extraction) and "assemble" (needle
    field construction) wall seconds — the Python-path counterparts of
    the C hot loop's identically-named stages; "crc"/"pwrite" land in
    Volume.write_needle, "reply" at the handler's formatting site."""
    t0 = time.perf_counter() if stages is not None else 0.0
    ctype = headers.get("content-type", "")
    part_filename = ""
    is_gzipped = False
    if ctype[:19].lower() == "multipart/form-data":
        from seaweedfs_tpu_torch.util.multipart import MalformedUpload, parse_upload

        try:
            part = parse_upload(body, ctype)
        except MalformedUpload as e:
            return None, "", str(e)
        data, ctype, part_filename = part.data, part.mime, part.filename
        is_gzipped = part.is_gzipped
    else:
        data = body
        # raw bodies may arrive pre-gzipped (Content-Encoding)
        is_gzipped = headers.get("content-encoding", "").lower() == "gzip"
    if stages is not None:
        t1 = time.perf_counter()
        stages["parse"] = t1 - t0
        t0 = t1
    n = Needle(cookie=fid.cookie, id=fid.key, data=data)
    if ctype and len(ctype) < 256 and ctype != "application/octet-stream":
        n.mime = ctype.encode()
        n.set_has_mime()
    fname = q.get("filename", "") or part_filename or url_filename
    if fname and len(fname) < 256:
        n.name = fname.encode()
        n.set_has_name()
        if fix_jpg_orientation and fname.lower().endswith((".jpg", ".jpeg")):
            from seaweedfs_tpu_torch import images

            n.data = images.fix_jpg_orientation(bytes(n.data))
    if is_gzipped:
        n.set_gzipped()
    elif len(n.data) > 128:
        # transparent server-side compression when the type says it
        # pays (needle_parse_multipart.go:86-97 + util/compression.go
        # IsGzippable); deterministic, so replica fan-out re-derives
        # identical needles
        from seaweedfs_tpu_torch.util.compression import is_gzippable

        fext = os.path.splitext(fname)[1] if fname else ""
        if is_gzippable(fext, ctype or "", bytes(n.data)):
            import gzip as _gzip

            # mtime=0: replicas re-derive the needle from the raw
            # body, so the stream must be identical
            # weedlint: ignore[hot-loop-gil-span] — transparent compression is the write contract (byte-identical replicas); the C tier declines these bodies by design
            packed = _gzip.compress(bytes(n.data), 6, mtime=0)
            if len(packed) < len(n.data):
                n.data = packed
                n.set_gzipped()
    if q.get("cm") == "true":
        n.set_is_chunk_manifest()
    # Seaweed-* request headers persist as needle pairs
    # (needle.go:37-42 PairNamePrefix + :101-113)
    pair_map = {
        k[8:]: v for k, v in headers.items() if k.lower().startswith("seaweed-")
    }
    if pair_map:
        pairs = json.dumps(pair_map).encode()
        if len(pairs) < 65536:
            n.pairs = pairs
            n.set_has_pairs()
    # ts= overrides the modification stamp; ttl= stores a per-needle
    # ttl (needle.go:79-81)
    try:
        n.last_modified = int(q.get("ts", "") or 0) or int(time.time())
    except ValueError:
        n.last_modified = int(time.time())
    n.set_has_last_modified_date()
    ttl_param = q.get("ttl", "")
    if ttl_param:
        from seaweedfs_tpu_torch.storage.ttl import TTL

        try:
            n.ttl = TTL.parse(ttl_param)
            if n.ttl.count:
                n.set_has_ttl()
        except ValueError:
            pass
    if stages is not None:
        stages["assemble"] = time.perf_counter() - t0
    return n, fname, None


def replicate_to_peers(
    fid: FileId,
    q: dict,
    method: str,
    body: bytes,
    headers,
    locations: list[str],
) -> str | None:
    """Fan the original write to the replica `locations` (already
    excluding the sender) with type=replicate so peers store without
    re-fanning (store_replicate.go:44-80). Returns an error message or
    None; all-or-error like the reference with WEED_HANDOFF=0: a replica
    that fails at the transport level or answers anything but 2xx fails
    the write. (The reference's `on_fail` seam, which spools such a hop
    as a hinted-handoff record, waits for server/handoff.py, ROADMAP
    item 10.)"""
    import urllib.error
    import urllib.request
    from urllib.parse import urlencode

    from seaweedfs_tpu_torch import trace

    params = {k: v for k, v in q.items() if k != "type"}
    params["type"] = "replicate"
    # replica fan-out is an internal hop: the peer's span must parent
    # under THIS server's span, not the client's original header
    trace_hdr = trace.header_value()
    path_q = f"/{fid}?{urlencode(params)}"
    for url in locations:
        try:
            req = urllib.request.Request(
                f"http://{url}{path_q}",
                data=body if method == "POST" else None,
                method=method,
            )
            if trace_hdr:
                req.add_header(trace.TRACE_HEADER, trace_hdr)
            # FastHeaders stores keys lowercased; look up both
            # spellings so a plain-dict caller keeps working too
            ct = headers.get("Content-Type") or headers.get("content-type")
            if ct:
                req.add_header("Content-Type", ct)
            ce = headers.get("Content-Encoding") or headers.get(
                "content-encoding"
            )
            if ce:  # pre-gzipped uploads must stay flagged on replicas
                req.add_header("Content-Encoding", ce)
            for hk, hv in headers.items():
                if hk.lower().startswith("seaweed-"):
                    req.add_header(hk, hv)  # pairs replicate too
            auth = headers.get("Authorization") or headers.get("authorization")
            if auth:  # keep the write jwt valid on the replica hop
                req.add_header("Authorization", auth)
            # weedlint: ignore[no-deadline] — one bounded 10 s replica hop inside the already-deadlined POST dispatch
            with urllib.request.urlopen(req, timeout=10) as r:
                if r.status >= 300:
                    return f"replica {url} returned {r.status}"
        except urllib.error.HTTPError as e:
            return f"replica {url} returned {e.code}"
        except OSError as e:
            return f"replica {url} failed: {e}"
    return None


def check_write_auth(guard, path: str, headers, client_ip: str) -> str | None:
    """JWT/white-list gate on mutating requests; None = allowed, else
    the 401 message (security/guard.go WhiteList+Secure wrapping of the
    write handlers). The jwt claim must match the request fid; every
    addressing form normalizes to the comma form the assign minted the
    token for (a _delta suffix stays part of the claimed id). Shared by
    the lead handler and the -shardWrites workers so sharded local
    writes enforce the same signature check."""
    if guard is None or not guard.is_write_active:
        return None
    from urllib.parse import parse_qs

    from seaweedfs_tpu_torch.security import UnauthorizedError, jwt_from_headers
    from seaweedfs_tpu_torch.storage.file_id import parse_url_path

    bare, _, qs = path.partition("?")
    token = jwt_from_headers(parse_qs(qs), headers)
    candidates = [bare.lstrip("/")]
    vid, fid_str, _fn, _ext, vid_only = parse_url_path(bare)
    if fid_str and not vid_only:
        comma = f"{vid},{fid_str}"
        if comma not in candidates:
            candidates.append(comma)
    err = None
    for cand in candidates:
        try:
            guard.check_write(client_ip, token, cand)
            return None
        except UnauthorizedError as e:
            err = e
    return str(err)
