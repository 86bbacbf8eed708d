"""Single-range `Range: bytes=` parsing shared by every HTTP surface
(volume, filer, S3 gateway) — one place for suffix/open-ended/416
semantics (RFC 7233; Go http.ServeContent role in the reference)."""

from __future__ import annotations


class RangeNotSatisfiable(ValueError):
    pass


def parse_range(header: str, total: int) -> tuple[int, int] | None:
    """(start, end) inclusive for the first range in `header`, or None
    when the header is absent/not a bytes range (serve the full body).
    Raises RangeNotSatisfiable for malformed or out-of-bounds ranges
    (respond 416 with `Content-Range: bytes */total`)."""
    if not header.startswith("bytes="):
        return None
    spec = header[6:].split(",")[0].strip()
    start_s, _, end_s = spec.partition("-")
    try:
        if start_s == "":
            nbytes = int(end_s)
            start, end = max(0, total - nbytes), total - 1
        else:
            start = int(start_s)
            end = int(end_s) if end_s else total - 1
    except ValueError:
        raise RangeNotSatisfiable(spec) from None
    if start >= total or start > end:
        raise RangeNotSatisfiable(spec)
    return start, min(end, total - 1)
