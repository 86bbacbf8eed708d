"""Core on-disk ABI constants and the Offset codec.

Bit-compatible with reference weed/storage/types/:
  needle_types.go:24-32  — sizes, TombstoneFileSize
  offset_4bytes.go       — 4-byte offset in units of 8-byte padding
                           (⇒ 32 GB max volume)
  offset_5bytes.go       — 5-byte variant (⇒ 8 TB); the reference picks
                           one at *build* time via a build tag
                           (Makefile `build_large`); here it is a
                           process-wide runtime config:
                           set_offset_size(5), or the
                           WEED_VOLUME_OFFSET_SIZE env var at import.
  needle_id_type.go      — 8-byte big-endian needle ids
"""

from __future__ import annotations

COOKIE_SIZE = 4
NEEDLE_ID_SIZE = 8
SIZE_SIZE = 4  # uint32
NEEDLE_HEADER_SIZE = COOKIE_SIZE + NEEDLE_ID_SIZE + SIZE_SIZE  # 16
NEEDLE_CHECKSUM_SIZE = 4
TIMESTAMP_SIZE = 8
NEEDLE_PADDING_SIZE = 8
TOMBSTONE_FILE_SIZE = 0xFFFFFFFF  # size==MaxUint32 marks a deleted entry

OFFSET_SIZE = 4  # default build: 4-byte offsets (see set_offset_size)
NEEDLE_MAP_ENTRY_SIZE = NEEDLE_ID_SIZE + OFFSET_SIZE + SIZE_SIZE  # 16

# 4-byte offset counts NEEDLE_PADDING_SIZE units: 2^32 * 8 = 32 GB
MAX_POSSIBLE_VOLUME_SIZE = (1 << (8 * OFFSET_SIZE)) * NEEDLE_PADDING_SIZE


def set_offset_size(n: int) -> None:
    """Switch the process to 4- or 5-byte stored offsets (the 5-byte
    build supports 8 TB volumes; .idx entries grow to 17 bytes). Must
    be called before any volume/index is opened — mixing sizes in one
    process corrupts indexes, exactly like mixing the reference's
    normal and `build_large` binaries on one dataset."""
    global OFFSET_SIZE, NEEDLE_MAP_ENTRY_SIZE, MAX_POSSIBLE_VOLUME_SIZE
    if n not in (4, 5):
        raise ValueError("offset size must be 4 or 5")
    OFFSET_SIZE = n
    NEEDLE_MAP_ENTRY_SIZE = NEEDLE_ID_SIZE + OFFSET_SIZE + SIZE_SIZE
    MAX_POSSIBLE_VOLUME_SIZE = (1 << (8 * OFFSET_SIZE)) * NEEDLE_PADDING_SIZE
    # idx entry layout follows the type constants
    from seaweedfs_tpu_torch.storage import idx as _idx

    _idx.ENTRY_SIZE = NEEDLE_MAP_ENTRY_SIZE


import os as _os  # noqa: E402

if _os.environ.get("WEED_VOLUME_OFFSET_SIZE") == "5":
    set_offset_size(5)


def offset_to_units(actual_offset: int) -> int:
    """Byte offset → stored offset units (offset_4bytes.go ToOffset)."""
    return actual_offset // NEEDLE_PADDING_SIZE


def units_to_offset(units: int) -> int:
    """Stored offset units → byte offset (ToAcutalOffset)."""
    return units * NEEDLE_PADDING_SIZE


def offset_to_bytes(units: int, offset_size: int | None = None) -> bytes:
    """Offset units → big-endian bytes (OffsetToBytes)."""
    return units.to_bytes(offset_size or OFFSET_SIZE, "big")


def bytes_to_offset(b: bytes) -> int:
    """Big-endian offset bytes → offset units (BytesToOffset)."""
    return int.from_bytes(b, "big")


def needle_id_to_bytes(needle_id: int) -> bytes:
    return (needle_id & 0xFFFFFFFFFFFFFFFF).to_bytes(8, "big")


def bytes_to_needle_id(b: bytes) -> int:
    return int.from_bytes(b[:8], "big")
