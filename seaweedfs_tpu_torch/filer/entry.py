"""Filer entry model (weed/filer2/entry.go + entry_codec.go).

An Entry is a full path plus attributes and the chunk list; stores
serialize the (attributes, chunks, extended) triple as the pb Entry
message, keyed by path — same codec role as entry_codec.go's
EncodeAttributesAndChunks.

The port of seaweedfs_tpu/filer/entry.py.
"""

from __future__ import annotations

import os
import time
from dataclasses import dataclass, field

from seaweedfs_tpu_torch.pb import filer_pb2


def split_path(full_path: str) -> tuple[str, str]:
    """"/a/b/c" → ("/a/b", "c"); "/" → ("/", "")."""
    full_path = normalize_path(full_path)
    if full_path == "/":
        return "/", ""
    dir_part, name = full_path.rsplit("/", 1)
    return dir_part or "/", name


def normalize_path(p: str) -> str:
    p = "/" + p.strip("/")
    while "//" in p:
        p = p.replace("//", "/")
    return p


def child_path(directory: str, name: str) -> str:
    """Join a directory and child name; correct at the root
    ("/", "x") → "/x", not "//x"."""
    return f"{directory.rstrip('/')}/{name}"


@dataclass
class Attr:
    mtime: int = 0  # seconds
    crtime: int = 0
    mode: int = 0o770
    uid: int = 0
    gid: int = 0
    mime: str = ""
    replication: str = ""
    collection: str = ""
    ttl_sec: int = 0
    symlink_target: str = ""
    file_size: int = 0  # explicit size; 0 = derive from chunk total

    @property
    def is_directory(self) -> bool:
        return bool(self.mode & 0o40000)  # os.ModeDir analogue


@dataclass
class Entry:
    full_path: str
    attr: Attr = field(default_factory=Attr)
    chunks: list = field(default_factory=list)  # list[filer_pb2.FileChunk]
    extended: dict = field(default_factory=dict)  # str -> bytes

    @property
    def directory(self) -> str:
        return split_path(self.full_path)[0]

    @property
    def name(self) -> str:
        return split_path(self.full_path)[1]

    @property
    def is_directory(self) -> bool:
        return self.attr.is_directory

    def size(self) -> int:
        # an explicit file_size wins (truncate can clamp below the
        # chunk total, since a kept chunk may span past the new EOF);
        # otherwise derive from the chunk list
        from seaweedfs_tpu_torch.filer.filechunks import total_size

        return self.attr.file_size or total_size(self.chunks)

    # --- pb codec (entry_codec.go) ---
    def to_pb(self) -> filer_pb2.Entry:
        e = filer_pb2.Entry(
            name=self.name,
            is_directory=self.is_directory,
            attributes=filer_pb2.Attributes(
                file_size=self.size(),
                mtime=self.attr.mtime,
                file_mode=self.attr.mode,
                uid=self.attr.uid,
                gid=self.attr.gid,
                crtime=self.attr.crtime,
                mime=self.attr.mime,
                replication=self.attr.replication,
                collection=self.attr.collection,
                ttl_sec=self.attr.ttl_sec,
                symlink_target=self.attr.symlink_target,
            ),
        )
        e.chunks.extend(self.chunks)
        for k, v in self.extended.items():
            e.extended[k] = v
        return e

    @staticmethod
    def from_pb(directory: str, pb_entry: filer_pb2.Entry) -> "Entry":
        a = pb_entry.attributes
        entry = Entry(
            full_path=normalize_path(f"{directory}/{pb_entry.name}"),
            attr=Attr(
                mtime=a.mtime,
                crtime=a.crtime,
                mode=a.file_mode | (0o40000 if pb_entry.is_directory else 0),
                uid=a.uid,
                gid=a.gid,
                mime=a.mime,
                replication=a.replication,
                collection=a.collection,
                ttl_sec=a.ttl_sec,
                symlink_target=a.symlink_target,
                file_size=a.file_size,
            ),
            chunks=list(pb_entry.chunks),
            extended=dict(pb_entry.extended),
        )
        return entry

    def encode(self) -> bytes:
        return self.to_pb().SerializeToString()

    @staticmethod
    def decode(full_path: str, data: bytes) -> "Entry":
        pb_entry = filer_pb2.Entry.FromString(data)
        directory, name = split_path(full_path)
        pb_entry.name = name
        return Entry.from_pb(directory, pb_entry)


def new_directory_entry(path: str, mode: int = 0o770) -> Entry:
    now = int(time.time())
    return Entry(
        full_path=normalize_path(path),
        attr=Attr(mtime=now, crtime=now, mode=mode | 0o40000),
    )
