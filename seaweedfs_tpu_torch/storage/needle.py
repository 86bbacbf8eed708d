"""Needle: one stored blob, and its bit-exact wire format.

Matches reference weed/storage/needle/needle.go:26-46 and
needle_read_write.go:31-120 (write) / 160-280 (read):

  header (16B): cookie u32 | id u64 | size u32          (big-endian)
  body v2/v3 when data present (size counts all of it):
      data_size u32 | data | flags u8
      [name_size u8 | name]        if FlagHasName
      [mime_size u8 | mime]        if FlagHasMime
      [last_modified 5B]           if FlagHasLastModifiedDate
      [ttl 2B]                     if FlagHasTtl
      [pairs_size u16 | pairs]     if FlagHasPairs
  trailer: checksum u32 (masked CRC32-C of data)
      [append_at_ns u64]           v3 only
      padding to 8B alignment — NOTE the reference quirk
      (needle_read_write.go:287-293): padding = 8 - (total % 8),
      i.e. ALWAYS 1..8 bytes, a full 8 when already aligned.

Version1 bodies are raw data + checksum (+padding).
"""

from __future__ import annotations

from dataclasses import dataclass, field

from seaweedfs_tpu_torch.storage import types as t
from seaweedfs_tpu_torch.storage.super_block import VERSION1, VERSION2, VERSION3
from seaweedfs_tpu_torch.storage.ttl import TTL
from seaweedfs_tpu_torch.util import bytesutil
from seaweedfs_tpu_torch.util.crc import crc32c, masked_value

# the one-call C record codec (csrc/needle_ext.c), built at first use
from seaweedfs_tpu_torch.native.ext import needle_ext as _needle_ext

FLAG_GZIP = 0x01
FLAG_HAS_NAME = 0x02
FLAG_HAS_MIME = 0x04
FLAG_HAS_LAST_MODIFIED_DATE = 0x08
FLAG_HAS_TTL = 0x10
FLAG_HAS_PAIRS = 0x20
FLAG_IS_CHUNK_MANIFEST = 0x80

LAST_MODIFIED_BYTES_LENGTH = 5
TTL_BYTES_LENGTH = 2


def padding_length(needle_size: int, version: int) -> int:
    """Reference needle_read_write.go:287 — never returns 0, returns 8
    when the unpadded record is already 8-byte aligned."""
    if version == VERSION3:
        unpadded = (
            t.NEEDLE_HEADER_SIZE + needle_size + t.NEEDLE_CHECKSUM_SIZE + t.TIMESTAMP_SIZE
        )
    else:
        unpadded = t.NEEDLE_HEADER_SIZE + needle_size + t.NEEDLE_CHECKSUM_SIZE
    return t.NEEDLE_PADDING_SIZE - (unpadded % t.NEEDLE_PADDING_SIZE)


def needle_body_length(needle_size: int, version: int) -> int:
    if version == VERSION3:
        return (
            needle_size
            + t.NEEDLE_CHECKSUM_SIZE
            + t.TIMESTAMP_SIZE
            + padding_length(needle_size, version)
        )
    return needle_size + t.NEEDLE_CHECKSUM_SIZE + padding_length(needle_size, version)


def get_actual_size(size: int, version: int) -> int:
    """Total on-disk record length for a needle of stored `size`."""
    return t.NEEDLE_HEADER_SIZE + needle_body_length(size, version)


class CorruptNeedle(ValueError):
    pass


class CookieMismatch(ValueError):
    pass


@dataclass
class Needle:
    cookie: int = 0
    id: int = 0
    size: int = 0  # stored size field (sum of body pieces), set on encode

    data: bytes = b""
    flags: int = 0
    name: bytes = b""
    mime: bytes = b""
    pairs: bytes = b""  # JSON-encoded extra name/value pairs
    last_modified: int = 0  # unix seconds, 5 bytes stored
    ttl: TTL | None = None

    checksum: int = 0  # RAW CRC32-C of data (the reference's n.Checksum;
    # the on-disk trailer stores masked_value(checksum), but Etag and
    # gRPC surfaces expose the raw value — crc.go Etag())
    append_at_ns: int = 0  # v3 only

    # --- flag helpers (needle.go Set*/Has*) ---
    def has_name(self) -> bool:
        return bool(self.flags & FLAG_HAS_NAME)

    def has_mime(self) -> bool:
        return bool(self.flags & FLAG_HAS_MIME)

    def has_last_modified_date(self) -> bool:
        return bool(self.flags & FLAG_HAS_LAST_MODIFIED_DATE)

    def has_ttl(self) -> bool:
        return bool(self.flags & FLAG_HAS_TTL)

    def has_pairs(self) -> bool:
        return bool(self.flags & FLAG_HAS_PAIRS)

    def is_gzipped(self) -> bool:
        return bool(self.flags & FLAG_GZIP)

    def is_chunked_manifest(self) -> bool:
        return bool(self.flags & FLAG_IS_CHUNK_MANIFEST)

    def set_has_name(self) -> None:
        self.flags |= FLAG_HAS_NAME

    def set_has_mime(self) -> None:
        self.flags |= FLAG_HAS_MIME

    def set_has_last_modified_date(self) -> None:
        self.flags |= FLAG_HAS_LAST_MODIFIED_DATE

    def set_has_ttl(self) -> None:
        self.flags |= FLAG_HAS_TTL

    def set_has_pairs(self) -> None:
        self.flags |= FLAG_HAS_PAIRS

    def set_gzipped(self) -> None:
        self.flags |= FLAG_GZIP

    def set_is_chunk_manifest(self) -> None:
        self.flags |= FLAG_IS_CHUNK_MANIFEST

    # --- encode ---
    def _body_size_v2(self) -> int:
        if not self.data:
            return 0
        size = 4 + len(self.data) + 1
        if self.has_name():
            size += 1 + min(len(self.name), 255)
        if self.has_mime():
            size += 1 + len(self.mime)
        if self.has_last_modified_date():
            size += LAST_MODIFIED_BYTES_LENGTH
        if self.has_ttl():
            size += TTL_BYTES_LENGTH
        if self.has_pairs():
            size += 2 + len(self.pairs)
        return size

    def to_bytes(self, version: int = VERSION3) -> bytes:
        """Serialize the full on-disk record (header..padding).

        Mirrors prepareWriteBuffer (needle_read_write.go:31) including its
        edge cases: empty data ⇒ size 0 and an empty body; name longer
        than 255 is truncated via NameSize capping.
        """
        self.checksum = crc32c(self.data)
        stored_checksum = masked_value(self.checksum)
        out = bytearray()
        if version == VERSION1:
            self.size = len(self.data)
            out += bytesutil.put_u32(self.cookie)
            out += bytesutil.put_u64(self.id)
            out += bytesutil.put_u32(self.size)
            out += self.data
            out += bytesutil.put_u32(stored_checksum)
            out += bytes(padding_length(self.size, version))
            return bytes(out)
        if version not in (VERSION2, VERSION3):
            raise ValueError(f"unsupported needle version {version}")

        self.size = self._body_size_v2()
        out += bytesutil.put_u32(self.cookie)
        out += bytesutil.put_u64(self.id)
        out += bytesutil.put_u32(self.size)
        if self.data:
            out += bytesutil.put_u32(len(self.data))
            out += self.data
            out.append(self.flags & 0xFF)
            if self.has_name():
                name = self.name[:255]
                out.append(len(name))
                out += name
            if self.has_mime():
                if len(self.mime) > 255:
                    raise ValueError("mime longer than 255 bytes")
                out.append(len(self.mime))
                out += self.mime
            if self.has_last_modified_date():
                out += bytesutil.put_u64(self.last_modified)[
                    8 - LAST_MODIFIED_BYTES_LENGTH :
                ]
            if self.has_ttl():
                ttl = self.ttl or TTL()
                out += ttl.to_bytes()
            if self.has_pairs():
                if len(self.pairs) >= 65536:
                    raise ValueError("pairs longer than 64KB")
                out += bytesutil.put_u16(len(self.pairs))
                out += self.pairs
        out += bytesutil.put_u32(stored_checksum)
        if version == VERSION3:
            out += bytesutil.put_u64(self.append_at_ns)
        out += bytes(padding_length(self.size, version))
        return bytes(out)

    def encode_record(self, version: int = VERSION3) -> bytes:
        """`to_bytes` fast path: the whole record (header..padding) in
        ONE native call (csrc/needle_ext.c — the prepareWriteBuffer
        single-pass shape, needle_read_write.go:31). Byte-identical to
        to_bytes."""
        blob, self.size, self.checksum = _needle_ext().encode(
            self.cookie,
            self.id,
            self.data,
            self.flags,
            self.name,
            self.mime,
            self.last_modified,
            (self.ttl or TTL()).to_bytes() if self.has_ttl() else None,
            self.pairs,
            version,
            self.append_at_ns,
        )
        return blob

    # --- decode ---
    @staticmethod
    def parse_header(blob: bytes) -> tuple[int, int, int]:
        """(cookie, id, size) from the 16-byte header."""
        if len(blob) < t.NEEDLE_HEADER_SIZE:
            raise CorruptNeedle(f"needle header truncated: {len(blob)} bytes")
        return (
            bytesutil.get_u32(blob, 0),
            bytesutil.get_u64(blob, t.COOKIE_SIZE),
            bytesutil.get_u32(blob, t.COOKIE_SIZE + t.NEEDLE_ID_SIZE),
        )

    @staticmethod
    def from_bytes(blob: bytes, version: int = VERSION3, size: int | None = None) -> "Needle":
        """Parse a full on-disk record (ReadBytes, needle_read_write.go:163).

        `size` — expected stored size from the index; mismatch raises.
        Verifies the data CRC. Fast path: one native parse+verify call
        (csrc/needle_ext.c decode); any native rejection re-parses in
        Python so error messages and edge semantics stay identical.
        """
        try:
            (
                cookie,
                nid,
                nsize,
                data,
                flags,
                name,
                mime,
                last_modified,
                ttl2,
                pairs,
                append_at_ns,
                crc,
            ) = _needle_ext().decode(blob, version, -1 if size is None else size)
        except ValueError:
            pass  # cold path: Python parse below raises the exact error
        else:
            n = Needle()
            n.cookie, n.id, n.size = cookie, nid, nsize
            n.data, n.flags, n.name, n.mime = data, flags, name, mime
            n.last_modified = last_modified
            if ttl2 is not None:
                n.ttl = TTL.from_bytes(ttl2)
            n.pairs = pairs
            n.append_at_ns = append_at_ns
            if nsize > 0:
                n.checksum = crc
            return n
        n = Needle()
        n.cookie, n.id, n.size = Needle.parse_header(blob)
        if size is not None and n.size != size:
            raise CorruptNeedle(
                f"entry not found: found id {n.id} size {n.size}, expected {size}"
            )
        h = t.NEEDLE_HEADER_SIZE
        if len(blob) < get_actual_size(n.size, version) - padding_length(n.size, version):
            raise CorruptNeedle(
                f"needle record truncated: {len(blob)} bytes for size {n.size}"
            )
        if version == VERSION1:
            n.data = bytes(blob[h : h + n.size])
        elif version in (VERSION2, VERSION3):
            n._parse_body_v2(blob[h : h + n.size])
        else:
            raise ValueError(f"unsupported needle version {version}")
        if n.size > 0:
            stored = bytesutil.get_u32(blob, h + n.size)
            fresh = crc32c(n.data)
            if stored != masked_value(fresh):
                raise CorruptNeedle("CRC error! Data On Disk Corrupted")
            n.checksum = fresh
        if version == VERSION3:
            ts_off = h + n.size + t.NEEDLE_CHECKSUM_SIZE
            n.append_at_ns = bytesutil.get_u64(blob, ts_off)
        return n

    def _parse_body_v2(self, body: bytes) -> None:
        """readNeedleDataVersion2 (needle_read_write.go:210-280)."""
        idx, end = 0, len(body)
        if idx < end:
            data_size = bytesutil.get_u32(body, idx)
            idx += 4
            if data_size + idx > end:
                raise CorruptNeedle("data_size out of range")
            self.data = bytes(body[idx : idx + data_size])
            idx += data_size
            if idx >= end:
                raise CorruptNeedle("flags byte out of range")
            self.flags = body[idx]
            idx += 1
        if idx < end and self.has_name():
            name_size = body[idx]
            idx += 1
            if name_size + idx > end:
                raise CorruptNeedle("name out of range")
            self.name = bytes(body[idx : idx + name_size])
            idx += name_size
        if idx < end and self.has_mime():
            mime_size = body[idx]
            idx += 1
            if mime_size + idx > end:
                raise CorruptNeedle("mime out of range")
            self.mime = bytes(body[idx : idx + mime_size])
            idx += mime_size
        if idx < end and self.has_last_modified_date():
            if LAST_MODIFIED_BYTES_LENGTH + idx > end:
                raise CorruptNeedle("last_modified out of range")
            self.last_modified = bytesutil.get_uint(
                body[idx : idx + LAST_MODIFIED_BYTES_LENGTH]
            )
            idx += LAST_MODIFIED_BYTES_LENGTH
        if idx < end and self.has_ttl():
            if TTL_BYTES_LENGTH + idx > end:
                raise CorruptNeedle("ttl out of range")
            self.ttl = TTL.from_bytes(body[idx : idx + TTL_BYTES_LENGTH])
            idx += TTL_BYTES_LENGTH
        if idx < end and self.has_pairs():
            if 2 + idx > end:
                raise CorruptNeedle("pairs_size out of range")
            pairs_size = bytesutil.get_u16(body, idx)
            idx += 2
            if pairs_size + idx > end:
                raise CorruptNeedle("pairs out of range")
            self.pairs = bytes(body[idx : idx + pairs_size])
            idx += pairs_size

    def disk_size(self, version: int = VERSION3) -> int:
        return get_actual_size(self.size, version)

    def etag(self) -> str:
        return bytesutil.put_u32(self.checksum).hex()
