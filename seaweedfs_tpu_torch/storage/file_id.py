"""External file ids: "<vid>,<key_hex><cookie_hex>".

Matches reference weed/storage/needle/file_id.go: the key is hex with
leading zeros stripped (minimum one nibble pair), the cookie is always
8 hex chars appended.
"""

from __future__ import annotations

import re

from dataclasses import dataclass

from seaweedfs_tpu_torch.storage.types import parse_cookie, parse_needle_id

_HEX_RE = re.compile(r"[0-9a-fA-F]+\Z")


@dataclass(frozen=True)
class FileId:
    volume_id: int
    key: int
    cookie: int

    def __str__(self) -> str:
        return f"{self.volume_id},{format_needle_id_cookie(self.key, self.cookie)}"

    @staticmethod
    def parse(fid: str) -> "FileId":
        comma = fid.find(",")
        if comma <= 0:
            raise ValueError(f"unknown file id {fid!r}")
        vid_str = fid[:comma]
        if not vid_str.isdigit():
            raise ValueError(f"unknown volume id in {fid!r}")
        vid = int(vid_str)
        key, cookie = parse_needle_id_cookie(fid[comma + 1 :])
        return FileId(vid, key, cookie)


def format_needle_id_cookie(key: int, cookie: int) -> str:
    """needle.go:173 formatNeedleIdCookie — key hex (zero-stripped,
    even-length) + 8-char cookie hex."""
    key_hex = f"{key:016x}"
    cookie_hex = f"{cookie:08x}"
    non_zero = 0
    while non_zero < len(key_hex) - 1 and key_hex[non_zero] == "0":
        non_zero += 1
    non_zero -= non_zero & 1  # keep whole byte pairs
    return key_hex[non_zero:] + cookie_hex


_MAX_KEY_COOKIE_LEN = (8 + 4) * 2  # (NeedleIdSize + CookieSize) hex chars


def parse_path_fid(vid_str: str, fid_str: str) -> "FileId":
    """fid string with the optional `_delta` appendix → FileId
    (needle.go:149 ParsePath): `01637037d6_3` reads needle id+3 —
    the addressing scheme chunked uploads use for the sub-fids minted
    from one assign with count=N."""
    if not vid_str.isdigit():
        raise ValueError(f"unknown volume id in {vid_str!r}")
    delta = 0
    sep = fid_str.rfind("_")
    if sep > 0:
        delta_str = fid_str[sep + 1 :]
        if not delta_str.isdigit():
            raise ValueError(f"bad fid delta in {fid_str!r}")
        fid_str, delta = fid_str[:sep], int(delta_str)
    key, cookie = parse_needle_id_cookie(fid_str)
    return FileId(int(vid_str), key + delta, cookie)


def parse_url_path(path: str) -> tuple[str, str, str, str, bool]:
    """Volume-server URL → (vid, fid, filename, ext, is_vid_only),
    the reference's public addressing forms (server/common.go:152
    parseURLPath):

      /3,01637037d6[.ext]          comma form (+optional extension)
      /3/01637037d6[.ext]          slash form
      /3/01637037d6/my photo.jpg   slash form with an explicit filename
      /3                           volume id only

    Percent-escapes are decoded PER SEGMENT after splitting (the
    filename may encode "/" or "," without changing the structure —
    Go's mux decodes the same way)."""
    from urllib.parse import unquote
    vid = fid = filename = ext = ""
    is_vid_only = False
    slashes = path.count("/")
    if slashes == 3:
        _, vid, fid, filename = path.split("/")
        filename = unquote(filename)
        i = filename.rfind(".")
        if i > 0:
            ext = filename[i:]
    elif slashes == 2:
        _, vid, fid = path.split("/")
        i = fid.rfind(".")
        if i > 0:
            fid, ext = fid[:i], fid[i:]
    else:
        sep = path.rfind("/")
        tail = path[sep + 1 :]
        comma = tail.rfind(",")
        if comma <= 0:
            return tail, "", "", "", True
        dot = tail.rfind(".")
        vid = tail[:comma]
        if dot > 0:
            fid, ext = tail[comma + 1 : dot], tail[dot:]
        else:
            fid = tail[comma + 1 :]
    return vid, fid, filename, ext, is_vid_only


def parse_needle_id_cookie(key_cookie: str) -> tuple[int, int]:
    """needle.go:181 ParseNeedleIdCookie (incl. the max-length check).

    One strict-hex validation over the whole string (Go ParseUint
    semantics: no sign/prefix/underscore), then plain slicing — this
    runs once per data-plane request, so it avoids the two-regex
    two-call shape of parse_needle_id + parse_cookie."""
    n = len(key_cookie)
    if n <= 8:
        raise ValueError(f"needle id too short: {key_cookie!r}")
    if n > _MAX_KEY_COOKIE_LEN:
        raise ValueError(f"key hash too long: {key_cookie!r}")
    if not _HEX_RE.match(key_cookie):
        # delegate for the exact per-field error text
        split = n - 8
        return parse_needle_id(key_cookie[:split]), parse_cookie(key_cookie[split:])
    split = n - 8
    return int(key_cookie[:split], 16), int(key_cookie[split:], 16)
