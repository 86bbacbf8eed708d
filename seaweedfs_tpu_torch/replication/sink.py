"""Replication sinks.

Behavioral match of weed/replication/sink/replication_sink.go (the
ReplicationSink interface: CreateEntry / UpdateEntry / DeleteEntry /
GetSinkToDirectory) with three concrete sinks:

* FilerSink — writes into a destination filer over gRPC, re-uploading
  every chunk through the destination cluster's AssignVolume + volume
  POST (sink/filersink/filer_sink.go + fetch_write.go). Chunk fids are
  cluster-local, so bytes always re-upload; the new chunk records the
  source fid for dedup-aware updates.
* LocalSink — materializes entries as plain files under a local
  directory.
* S3Sink — writes whole objects into any S3-compatible endpoint via
  the in-repo SigV4 client (sink/s3sink/s3_sink.go, minus the aws-sdk),
  the port's own S3 gateway included.

The port of seaweedfs_tpu/replication/sink.py. The cloud sinks (GCS,
Azure, B2) are in cloud_sinks.py, each an AssemblingObjectSink.
"""

from __future__ import annotations

import os

import grpc

from seaweedfs_tpu_torch.client import operation as op
from seaweedfs_tpu_torch.pb import filer_pb2 as fpb, rpc
from seaweedfs_tpu_torch.replication.source import FilerSource
from seaweedfs_tpu_torch.util import wlog


class ReplicationSink:
    def get_sink_to_directory(self) -> str:
        raise NotImplementedError

    def set_source_filer(self, source: FilerSource) -> None:
        self.source = source

    def create_entry(self, key: str, entry: fpb.Entry) -> None:
        raise NotImplementedError

    def update_entry(
        self, key: str, old_entry: fpb.Entry, new_parent_path: str,
        new_entry: fpb.Entry, delete_chunks: bool,
    ) -> bool:
        """Returns True when an existing sink entry was found+updated."""
        raise NotImplementedError

    def delete_entry(self, key: str, is_directory: bool, delete_chunks: bool) -> None:
        raise NotImplementedError


class FilerSink(ReplicationSink):
    name = "filer"

    def __init__(
        self,
        grpc_address: str,
        directory: str = "/backup",
        replication: str = "",
        collection: str = "",
        ttl_sec: int = 0,
    ):
        self.filer = grpc_address
        self.dir = directory.rstrip("/")
        self.replication = replication
        self.collection = collection
        self.ttl_sec = ttl_sec
        self.source: FilerSource | None = None
        self._channel: grpc.Channel | None = None

    def _stub(self):
        if self._channel is None:
            self._channel = rpc.dial(rpc.grpc_address(self.filer))
        return rpc.filer_stub(self._channel)

    def get_sink_to_directory(self) -> str:
        return self.dir

    # ------------------------------------------------------------------
    def _replicate_chunks(self, chunks) -> list[fpb.FileChunk]:
        """Fetch every chunk from the source cluster and upload it into
        the sink cluster (fetch_write.go replicateChunks)."""
        out = []
        for chunk in chunks:
            data = self.source.read_chunk(chunk.fid)
            ar = self._stub().AssignVolume(
                fpb.AssignVolumeRequest(
                    count=1,
                    collection=self.collection,
                    replication=self.replication,
                    ttl_sec=self.ttl_sec,
                )
            )
            ur = op.upload(f"{ar.url}/{ar.fid}", data, jwt=ar.auth)
            if ur.error:
                raise RuntimeError(f"sink upload {ar.fid}: {ur.error}")
            out.append(
                fpb.FileChunk(
                    fid=ar.fid,
                    offset=chunk.offset,
                    size=chunk.size,
                    mtime=chunk.mtime,
                    e_tag=chunk.e_tag,
                    source_fid=chunk.fid,
                )
            )
        return out

    def create_entry(self, key: str, entry: fpb.Entry) -> None:
        directory, _, name = key.rpartition("/")
        new_entry = fpb.Entry(
            name=name,
            is_directory=entry.is_directory,
            attributes=entry.attributes,
        )
        if not entry.is_directory:
            new_entry.chunks.extend(self._replicate_chunks(entry.chunks))
        self._stub().CreateEntry(
            fpb.CreateEntryRequest(directory=directory or "/", entry=new_entry)
        )

    def update_entry(self, key, old_entry, new_parent_path, new_entry, delete_chunks) -> bool:
        directory, _, name = key.rpartition("/")
        try:
            existing = self._stub().LookupDirectoryEntry(
                fpb.LookupDirectoryEntryRequest(directory=directory or "/", name=name)
            ).entry
        except grpc.RpcError:
            return False
        # keep sink chunks that mirror source chunks still present; add
        # re-uploaded copies of new source chunks (filer_sink.go UpdateEntry)
        surviving_sources = {c.fid for c in new_entry.chunks}
        kept = [c for c in existing.chunks if c.source_fid in surviving_sources]
        mirrored = {c.source_fid for c in kept}
        fresh = [c for c in new_entry.chunks if c.fid not in mirrored]
        updated = fpb.Entry(
            name=name,
            is_directory=new_entry.is_directory,
            attributes=new_entry.attributes,
        )
        updated.chunks.extend(kept)
        if fresh:
            updated.chunks.extend(self._replicate_chunks(fresh))
        self._stub().UpdateEntry(
            fpb.UpdateEntryRequest(directory=directory or "/", entry=updated)
        )
        return True

    def delete_entry(self, key: str, is_directory: bool, delete_chunks: bool) -> None:
        directory, _, name = key.rpartition("/")
        try:
            self._stub().DeleteEntry(
                fpb.DeleteEntryRequest(
                    directory=directory or "/",
                    name=name,
                    is_delete_data=delete_chunks,
                    is_recursive=is_directory,
                )
            )
        except grpc.RpcError as e:
            wlog.warning("sink delete %s: %s", key, e)

    def close(self) -> None:
        if self._channel is not None:
            self._channel.close()


class LocalSink(ReplicationSink):
    """Write replicated entries as plain files under a directory — the
    object-store-sink analogue testable without cloud SDKs. A file is
    written beside its name and renamed over it once every chunk is in,
    where the reference writes in place: a chunk that cannot be read
    leaves no file behind, or the previous one as it was."""

    name = "local"

    def __init__(self, directory: str):
        self.dir = directory.rstrip("/")
        os.makedirs(self.dir, exist_ok=True)
        self.source: FilerSource | None = None

    def get_sink_to_directory(self) -> str:
        return ""

    def _local_path(self, key: str) -> str:
        return os.path.join(self.dir, key.lstrip("/"))

    def create_entry(self, key: str, entry: fpb.Entry) -> None:
        path = self._local_path(key)
        if entry.is_directory:
            os.makedirs(path, exist_ok=True)
            return
        directory, name = os.path.split(path)
        os.makedirs(directory, exist_ok=True)
        tmp = os.path.join(directory, f".{name}.replicating")
        try:
            with open(tmp, "wb") as f:
                for chunk in sorted(entry.chunks, key=lambda c: c.offset):
                    f.seek(chunk.offset)
                    f.write(self.source.read_chunk(chunk.fid))
            os.replace(tmp, path)
        except BaseException:
            if os.path.exists(tmp):
                os.remove(tmp)
            raise

    def update_entry(self, key, old_entry, new_parent_path, new_entry, delete_chunks) -> bool:
        existed = os.path.exists(self._local_path(key))
        self.create_entry(key, new_entry)
        return existed

    def delete_entry(self, key: str, is_directory: bool, delete_chunks: bool) -> None:
        path = self._local_path(key)
        if is_directory:
            import shutil

            shutil.rmtree(path, ignore_errors=True)
        elif os.path.exists(path):
            os.remove(path)


class AssemblingObjectSink(ReplicationSink):
    """Shared shape of the object-store sinks (S3/GCS/Azure/B2): each
    file entry becomes one object, assembled from its chunks through
    the visible-interval algebra (mtime-resolved overlaps, size-clamped
    views — NOT a raw offset sort, which would resurrect overwritten
    bytes and let truncated entries grow back past their EOF);
    directories are implicit in keys, recursive deletes sweep the
    replicated prefix. Providers implement _put/_delete/_list."""

    def __init__(self, directory: str = ""):
        self.dir = directory.strip("/")
        self.source: FilerSource | None = None

    def get_sink_to_directory(self) -> str:
        return ""

    def set_source_filer(self, source: FilerSource) -> None:
        self.source = source

    def _key(self, key: str) -> str:
        k = key.lstrip("/")
        return f"{self.dir}/{k}" if self.dir else k

    def _assemble(self, entry: fpb.Entry) -> bytes:
        from seaweedfs_tpu_torch.filer import filechunks

        size = entry.attributes.file_size or sum(c.size for c in entry.chunks)
        buf = bytearray(size)
        for view in filechunks.view_from_chunks(list(entry.chunks), 0, size):
            data = self.source.read_chunk(view.fid)
            piece = data[view.offset : view.offset + view.size]
            buf[view.logic_offset : view.logic_offset + len(piece)] = piece
        return bytes(buf)

    def create_entry(self, key: str, entry: fpb.Entry) -> None:
        if entry.is_directory:
            return  # object stores have no directories
        self._put(self._key(key), self._assemble(entry))

    def update_entry(
        self, key, old_entry, new_parent_path, new_entry, delete_chunks
    ) -> bool:
        self.create_entry(key, new_entry)
        return True  # puts are idempotent upserts in an object store

    def delete_entry(self, key: str, is_directory: bool, delete_chunks: bool) -> None:
        if is_directory:
            # a recursive source delete emits ONE event for the top
            # directory; sweep the whole replicated prefix or every
            # object under it is orphaned in the bucket forever
            prefix = self._key(key).rstrip("/") + "/"
            for obj_key in self._list(prefix):
                self._delete(obj_key)
            return
        self._delete(self._key(key))

    # provider primitives
    def _put(self, name: str, data: bytes) -> None:
        raise NotImplementedError

    def _delete(self, name: str) -> None:
        raise NotImplementedError

    def _list(self, prefix: str) -> list[str]:
        raise NotImplementedError


class S3Sink(AssemblingObjectSink):
    """Replicate into an S3-compatible bucket (sink/s3sink/s3_sink.go).
    Works against any SigV4 endpoint including this repo's own gateway."""

    name = "s3"

    def __init__(
        self,
        endpoint: str,
        bucket: str,
        access_key: str = "",
        secret_key: str = "",
        directory: str = "",
        region: str = "us-east-1",
    ):
        super().__init__(directory)
        from seaweedfs_tpu_torch.s3api.client import S3Client

        self.client = S3Client(endpoint, access_key, secret_key, region=region)
        self.bucket = bucket

    def _put(self, name: str, data: bytes) -> None:
        self.client.put_object(self.bucket, name, data)

    def _delete(self, name: str) -> None:
        self.client.delete_object(self.bucket, name)

    def _list(self, prefix: str) -> list[str]:
        return list(self.client.list_objects(self.bucket, prefix))

