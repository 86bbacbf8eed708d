"""The filer core (the port of seaweedfs_tpu/filer/): entries, the chunk
algebra, the metadata stores and the Filer namespace layer."""
from seaweedfs_tpu_torch.filer.entry import Attr, Entry, new_directory_entry
from seaweedfs_tpu_torch.filer.filer import Filer
from seaweedfs_tpu_torch.filer.filerstore import (
    EntryNotFound,
    FilerStore,
    MemoryStore,
    SortedLogStore,
    SqliteStore,
    new_store,
)
from seaweedfs_tpu_torch.filer.lsm import LsmStore

__all__ = [
    "Attr",
    "Entry",
    "EntryNotFound",
    "Filer",
    "FilerStore",
    "LsmStore",
    "MemoryStore",
    "SortedLogStore",
    "SqliteStore",
    "new_directory_entry",
    "new_store",
]
