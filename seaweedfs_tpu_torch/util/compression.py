"""Server-side transparent compression policy.

Behavioral match of weed/util/compression.go IsGzippable /
IsGzippableFileType: the volume server auto-gzips uploads whose
extension/mime say "compresses well" (text, code, json/xml, svg) and
skips already-compressed families (archives, jpeg/png, video); unknown
types fall back to a mostly-text sniff of the payload.
"""

from __future__ import annotations

_ALWAYS = {
    ".svg", ".bmp", ".pdf", ".txt", ".html", ".htm", ".css", ".js",
    ".json", ".php", ".java", ".go", ".rb", ".c", ".cpp", ".h", ".hpp",
}
_NEVER = {".zip", ".rar", ".gz", ".bz2", ".xz", ".png", ".jpg", ".jpeg"}

_TEXTCHARS = bytes(range(32, 127)) + b"\t\n\r\f\b\x1b"


def _is_mostly_text(data: bytes) -> bool:
    sample = data[:1024]
    if not sample or b"\x00" in sample:
        return False
    # translate-delete counts non-text bytes in C: this runs on the
    # volume write hot path for every extension the type rules do not
    # decide (a Python per-byte loop here costs ~40 us/write)
    non_text = len(sample.translate(None, _TEXTCHARS))
    return non_text / len(sample) < 0.15


def is_gzippable_file_type(ext: str, mtype: str) -> tuple[bool, bool]:
    """(should_be_zipped, i_am_sure) — compression.go:54."""
    ext = ext.lower()
    if mtype.startswith("text/"):
        return True, True
    if ext in (".svg", ".bmp"):
        return True, True
    if mtype.startswith("image/"):
        return False, True
    if ext in _NEVER:
        return False, True
    if ext in _ALWAYS:
        return True, True
    if mtype.startswith("application/"):
        if mtype.endswith("xml") or mtype.endswith("json") or mtype.endswith(
            "script"
        ):
            return True, True
    return False, False


def is_gzippable(ext: str, mtype: str, data: bytes) -> bool:
    """compression.go:40 — type rules first, text sniff as tiebreak."""
    should, sure = is_gzippable_file_type(ext, mtype)
    if sure:
        return should
    return _is_mostly_text(data)


def try_gunzip(data: bytes) -> bytes:
    """Decompress if possible, else return the bytes unchanged — the
    serve-stored-bytes fallback for needles whose gzip flag lies.
    gzip.decompress raises EOFError/zlib.error (NOT OSError subclasses)
    on truncated streams, so the net must cover all three."""
    import gzip
    import zlib

    try:
        return gzip.decompress(data)
    except (OSError, EOFError, zlib.error):
        return data
