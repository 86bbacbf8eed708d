""".idx index-file entries: 16 bytes = key u64 | offset u32 | size u32.

Matches reference weed/storage/idx/walk.go. Offsets are stored in
8-byte units (storage/types.py); size==TOMBSTONE_FILE_SIZE or a zero
offset marks a deletion entry.

Entries are exposed as (key, offset_units, size) int tuples; numpy
bulk paths (sorting for .ecx, binary search) operate on the raw bytes
as a [N, 16] u8 view to avoid per-entry Python cost on million-entry
indexes.
"""

from __future__ import annotations

import io
from typing import Callable, Iterator

import numpy as np

from seaweedfs_tpu_torch.storage import types as t
from seaweedfs_tpu_torch.util import bytesutil

ENTRY_SIZE = t.NEEDLE_MAP_ENTRY_SIZE  # 16 (17 under 5-byte offsets)


def pack_entry(key: int, offset_units: int, size: int) -> bytes:
    return (
        t.needle_id_to_bytes(key)
        + t.offset_to_bytes(offset_units)
        + bytesutil.put_u32(size)
    )


def unpack_entry(b: bytes, off: int = 0) -> tuple[int, int, int]:
    key = bytesutil.get_u64(b, off)
    offset_units = t.bytes_to_offset(b[off + 8 : off + 8 + t.OFFSET_SIZE])
    size = bytesutil.get_u32(b, off + 8 + t.OFFSET_SIZE)
    return key, offset_units, size


def iter_entries(data: bytes) -> Iterator[tuple[int, int, int]]:
    for off in range(0, len(data) - ENTRY_SIZE + 1, ENTRY_SIZE):
        yield unpack_entry(data, off)


def walk_index_file(
    f: io.BufferedIOBase,
    fn: Callable[[int, int, int], None],
    rows_to_read: int = 1024,
) -> None:
    """Stream (key, offset_units, size) entries to `fn` (idx/walk.go:14)."""
    f.seek(0)
    while True:
        chunk = f.read(ENTRY_SIZE * rows_to_read)
        if not chunk:
            return
        for off in range(0, len(chunk) - ENTRY_SIZE + 1, ENTRY_SIZE):
            fn(*unpack_entry(chunk, off))
        if len(chunk) < ENTRY_SIZE * rows_to_read:
            return


# --- numpy bulk views -------------------------------------------------------

def entries_as_arrays(data: bytes) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Decode a whole .idx/.ecx byte blob to (keys u64, offsets u64,
    sizes u32) arrays in one vectorized pass. Honors the process
    offset size (4- or 5-byte entries)."""
    osz = t.OFFSET_SIZE
    entry = t.NEEDLE_MAP_ENTRY_SIZE
    n = len(data) // entry
    raw = np.frombuffer(data, dtype=np.uint8, count=n * entry).reshape(n, entry)
    keys = raw[:, :8].copy().view(">u8").reshape(n).astype(np.uint64)
    # big-endian offsets of arbitrary width: widen to 8 bytes, view u64
    off8 = np.zeros((n, 8), dtype=np.uint8)
    off8[:, 8 - osz :] = raw[:, 8 : 8 + osz]
    offsets = off8.view(">u8").reshape(n).astype(np.uint64)
    sizes = (
        raw[:, 8 + osz : 8 + osz + 4].copy().view(">u4").reshape(n).astype(np.uint32)
    )
    return keys, offsets, sizes


def arrays_to_entries(keys: np.ndarray, offsets: np.ndarray, sizes: np.ndarray) -> bytes:
    osz = t.OFFSET_SIZE
    entry = t.NEEDLE_MAP_ENTRY_SIZE
    n = len(keys)
    raw = np.empty((n, entry), dtype=np.uint8)
    raw[:, :8] = keys.astype(">u8").reshape(n, 1).view(np.uint8)
    off8 = offsets.astype(">u8").reshape(n, 1).view(np.uint8).reshape(n, 8)
    raw[:, 8 : 8 + osz] = off8[:, 8 - osz :]
    raw[:, 8 + osz : 8 + osz + 4] = sizes.astype(">u4").reshape(n, 1).view(np.uint8)
    return raw.tobytes()
