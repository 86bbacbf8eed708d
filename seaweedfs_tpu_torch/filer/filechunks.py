"""Chunk algebra: overlapping writes → visible intervals → read views.

Behavioral match of weed/filer2/filechunks.go: a file is a list of
FileChunk writes; later writes (higher mtime) overwrite earlier ones.
`non_overlapping_visible_intervals` resolves the write history into
disjoint intervals, `view_from_chunks` turns a (offset,size) read into
per-chunk views, `compact_file_chunks` splits fully-hidden chunks out
as garbage. Semantics pinned by the ported table tests from
filer2/filechunks_test.go.

The port of seaweedfs_tpu/filer/filechunks.py.
"""

from __future__ import annotations

from dataclasses import dataclass

from seaweedfs_tpu_torch.pb import filer_pb2


@dataclass
class VisibleInterval:
    start: int
    stop: int
    fid: str
    mtime: int
    is_full_chunk: bool = False


@dataclass
class ChunkView:
    fid: str
    offset: int  # offset within the stored chunk
    size: int
    logic_offset: int  # offset within the file
    is_full_chunk: bool = False


def total_size(chunks) -> int:
    size = 0
    for c in chunks:
        size = max(size, c.offset + c.size)
    return size


def etag(chunks) -> str:
    if len(chunks) == 1:
        return chunks[0].e_tag
    # FNV-1a 32-bit over the concatenated chunk etags (filechunks.go ETag)
    h = 0x811C9DC5
    for c in chunks:
        for b in c.e_tag.encode():
            h ^= b
            h = (h * 0x01000193) & 0xFFFFFFFF
    return f"{h:x}"


def non_overlapping_visible_intervals(chunks) -> list[VisibleInterval]:
    """Fold the chunk list, oldest write first, into disjoint visible
    intervals (NonOverlappingVisibleIntervals)."""
    visibles: list[VisibleInterval] = []
    for chunk in sorted(chunks, key=lambda c: c.mtime):
        new = VisibleInterval(
            start=chunk.offset,
            stop=chunk.offset + chunk.size,
            fid=chunk.fid,
            mtime=chunk.mtime,
            is_full_chunk=True,
        )
        carved: list[VisibleInterval] = []
        for v in visibles:
            # keep the parts of v not covered by the new write
            if v.start < new.start < v.stop:
                carved.append(VisibleInterval(v.start, new.start, v.fid, v.mtime, False))
            if v.start < new.stop < v.stop:
                carved.append(VisibleInterval(new.stop, v.stop, v.fid, v.mtime, False))
            if new.stop <= v.start or v.stop <= new.start:
                carved.append(v)
        carved.append(new)
        carved.sort(key=lambda v: v.start)
        visibles = carved
    return visibles


def view_from_visible_intervals(
    visibles: list[VisibleInterval], offset: int, size: int
) -> list[ChunkView]:
    stop = offset + size
    views: list[ChunkView] = []
    for v in visibles:
        # reference parity (filer2/filechunks.go ViewFromVisibleIntervals):
        # views advance only while contiguous — a hole ends the read, it
        # is NOT zero-filled (pinned by the ported test table, case 4)
        if v.start <= offset < v.stop and offset < stop:
            is_full = v.is_full_chunk and v.start == offset and v.stop <= stop
            views.append(
                ChunkView(
                    fid=v.fid,
                    offset=offset - v.start,
                    size=min(v.stop, stop) - offset,
                    logic_offset=offset,
                    is_full_chunk=is_full,
                )
            )
            offset = min(v.stop, stop)
    return views


def view_from_chunks(chunks, offset: int, size: int) -> list[ChunkView]:
    return view_from_visible_intervals(
        non_overlapping_visible_intervals(chunks), offset, size
    )


def compact_file_chunks(chunks):
    """Split chunks into (still-visible, fully-hidden garbage)
    (CompactFileChunks)."""
    visible_fids = {v.fid for v in non_overlapping_visible_intervals(chunks)}
    compacted, garbage = [], []
    for c in chunks:
        (compacted if c.fid in visible_fids else garbage).append(c)
    return compacted, garbage


def minus_chunks(as_, bs):
    """Chunks in `as_` whose fid is not in `bs` (MinusChunks)."""
    b_fids = {c.fid for c in bs}
    return [c for c in as_ if c.fid not in b_fids]


def make_chunk(fid: str, offset: int, size: int, mtime: int, e_tag: str = "") -> filer_pb2.FileChunk:
    return filer_pb2.FileChunk(fid=fid, offset=offset, size=size, mtime=mtime, e_tag=e_tag)
