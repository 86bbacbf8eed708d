"""Needle index lookups: the sorted-file snapshot (SortedNeedleMap) that
an EC volume binary-searches in its .ecx (needle_map_sorted_file.go,
ec_volume.go:199 SearchNeedleFromSortedIndex).

The port of seaweedfs_tpu/storage/needle_map.py's NeedleValue and
SortedNeedleMap; the writable maps (CompactNeedleMap, DbNeedleMap) come
with the port's Volume.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import numpy as np

from seaweedfs_tpu_torch.storage import idx as idx_codec
from seaweedfs_tpu_torch.storage import types as t


@dataclass(frozen=True)
class NeedleValue:
    key: int
    offset: int  # units of 8 bytes (types.py)
    size: int

    @property
    def actual_offset(self) -> int:
        return t.units_to_offset(self.offset)


class SortedNeedleMap:
    """Read-only binary-searchable snapshot of a sorted index file
    (.ecx or sorted .idx) held as numpy arrays."""

    def __init__(self, keys: np.ndarray, offsets: np.ndarray, sizes: np.ndarray):
        self.keys = keys
        self.offsets = offsets
        self.sizes = sizes

    @classmethod
    def load(cls, path: str) -> "SortedNeedleMap":
        with open(path, "rb") as f:
            data = f.read()
        keys, offsets, sizes = idx_codec.entries_as_arrays(data)
        return cls(keys, offsets, sizes)

    def search(self, key: int) -> Optional[NeedleValue]:
        i = int(np.searchsorted(self.keys, np.uint64(key)))
        if i >= len(self.keys) or int(self.keys[i]) != key:
            return None
        return NeedleValue(key, int(self.offsets[i]), int(self.sizes[i]))

    def entry_index(self, key: int) -> int:
        """Index of `key`'s 16-byte entry in the backing file, or -1 —
        used to tombstone entries in place (MarkNeedleDeleted)."""
        i = int(np.searchsorted(self.keys, np.uint64(key)))
        if i >= len(self.keys) or int(self.keys[i]) != key:
            return -1
        return i

    def __len__(self) -> int:
        return len(self.keys)
