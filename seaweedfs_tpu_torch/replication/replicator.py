"""Event → sink dispatch.

Behavioral match of weed/replication/replicator.go:34-60: map the
source key into the sink directory, then route by (old, new) presence:
delete / create / update-with-create-fallback."""

from __future__ import annotations

from seaweedfs_tpu_torch.pb import filer_pb2 as fpb
from seaweedfs_tpu_torch.replication.sink import ReplicationSink
from seaweedfs_tpu_torch.replication.source import FilerSource
from seaweedfs_tpu_torch.util import wlog


class Replicator:
    def __init__(self, source: FilerSource, sink: ReplicationSink):
        self.source = source
        self.sink = sink
        sink.set_source_filer(source)

    def replicate(self, key: str, message: fpb.EventNotification) -> None:
        src_dir = self.source.dir
        if src_dir != "/" and not key.startswith(src_dir):
            wlog.V(4).info("skipping %s outside of %s", key, src_dir)
            return
        suffix = key[len(src_dir):] if src_dir != "/" else key
        new_key = (self.sink.get_sink_to_directory().rstrip("/") + suffix) or suffix

        has_old = bool(message.old_entry.name) or message.old_entry.is_directory
        has_new = bool(message.new_entry.name) or message.new_entry.is_directory
        if has_old and not has_new:
            self.sink.delete_entry(
                new_key, message.old_entry.is_directory, message.delete_chunks
            )
            return
        if has_new and not has_old:
            self.sink.create_entry(new_key, message.new_entry)
            return
        if not has_old and not has_new:
            wlog.warning("weird empty event for %s", key)
            return
        found = self.sink.update_entry(
            new_key,
            message.old_entry,
            message.new_parent_path,
            message.new_entry,
            message.delete_chunks,
        )
        if not found:
            # existing entry not at the sink yet: fall back to create
            # (replicator.go:56-60)
            self.sink.create_entry(new_key, message.new_entry)
